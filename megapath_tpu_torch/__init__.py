"""megapath-tpu ported to PyTorch and CUDA.

The port of ``megapath_tpu`` to PyTorch, with the TPU's Pallas kernels
rewritten by hand for NVIDIA Hopper. It mirrors the reference package's
layout and names:

- ``megapath_tpu_torch.pipeline`` the MegaPath pipeline (bbduk -> human
                                and ribosome filters -> NT shards -> SPIKE
                                -> reassign -> Kraken reports) on the
                                port's engines.
- ``megapath_tpu_torch.align``  the paired-end alignment engine: MMP walk
                                and SA locate on the host or on the device,
                                pairing on the host, DP on the engine's
                                torch device.
- ``megapath_tpu_torch.ops``    the kernels' wrappers: plain PyTorch
                                versions and the hand-written CUDA kernels
                                (``csrc/``).
- ``megapath_tpu_torch.index``  shard packing and the FM index (suffix
                                array sorted on a torch device), the
                                offline DB tools (``dbtools``).
- ``megapath_tpu_torch.io``     FASTQ/FASTA input, batch streaming, LSAM,
                                SAM/BAM, SAM -> cfq.
- ``megapath_tpu_torch.filters``, ``.taxonomy``, ``.classify``, ``.utils``
                                the pipeline's host stages (bbduk and
                                SPIKE with host C++ in ``csrc/host/``,
                                built by ``native.py``), taxonomy, reports,
                                reassignment, the protein-remap and cleanup
                                tools, stage timing, accuracy evaluation.
- ``megapath_tpu_torch.cli``    the command line (``megapath-tpu-torch``).
- ``megapath_tpu_torch.convert`` the state carried across from the
                                reference (parameters, shard, FM index,
                                taxonomy).

It imports ``torch`` and numpy, and nothing of ``jax`` or ``megapath_tpu``.
"""

__version__ = "0.1.0"
