"""megapath-tpu ported to PyTorch and CUDA.

The port of ``megapath_tpu`` to PyTorch, with the TPU's Pallas kernels
rewritten by hand for NVIDIA Hopper. It mirrors the reference package's
layout and names:

- ``megapath_tpu_torch.align``  the paired-end alignment engine on host
                                seeding: numpy MMP walk and pairing, DP on
                                the engine's torch device.
- ``megapath_tpu_torch.ops``    the DP: plain PyTorch versions and the
                                hand-written CUDA kernel (``csrc/``).
- ``megapath_tpu_torch.index``  shard packing and the FM index (suffix
                                array sorted on a torch device).
- ``megapath_tpu_torch.io``     FASTQ/FASTA input.
- ``megapath_tpu_torch.convert`` the state carried across from the
                                reference (parameters, shard, FM index).

It imports ``torch`` and numpy, and nothing of ``jax`` or ``megapath_tpu``.
"""

__version__ = "0.1.0"
