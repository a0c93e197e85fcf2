from megapath_tpu_torch.amplicon.debruijn import DeBruijnGraph, candidate_haplotypes  # noqa: F401
from megapath_tpu_torch.amplicon.realign import realign_window, WindowRealignment  # noqa: F401
