from megapath_tpu_torch.align.params import AlignParams, MmpParams  # noqa: F401
from megapath_tpu_torch.align.seeding import (  # noqa: F401
    Seeds,
    SeedPositions,
    make_walkers_fast,
    mmp_seed,
    decode_seeds,
)
from megapath_tpu_torch.align.pairing import Candidates, pair_candidates  # noqa: F401
from megapath_tpu_torch.align.engine import AlignEngine, BatchHits  # noqa: F401
from megapath_tpu_torch.align.output import (  # noqa: F401
    best_per_seq,
    format_comment,
    emit_cfq,
    coverage_intervals,
)
