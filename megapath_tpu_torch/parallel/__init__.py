"""The grid steps of stage 2, each cell of a (data, shard) grid of torch
devices aligning one data block against one shard: the whole alignment
engine (``spmd_full``, the pipeline's one-program backend), the reduced
seed -> pair -> DP -> merge step (``spmd``) and the DP at given candidate
positions (``dist``).

``make_mesh`` is ``spmd_full.make_mesh``, which the pipeline and the CLI
call; the reference's ``dist.make_mesh`` (a shard axis of 2 for an even
device count) is reached by its module path."""

from megapath_tpu_torch.parallel.spmd_full import (  # noqa: F401
    LEAN_CAPS,
    FMMetaPad,
    Mesh,
    SpmdCaps,
    SpmdHits,
    StageEvents,
    build_spmd_full_engine,
    fm_meta,
    grid_devices,
    make_mesh,
    place_spmd_full_inputs,
    spmd_hits_to_batch,
    spmd_payload_stats,
)
from megapath_tpu_torch.parallel.spmd import (  # noqa: F401
    SpmdAlignOut,
    StackedFM,
    build_spmd_engine_step,
    make_mesh_for,
    pad_and_index_shards,
    place_spmd_inputs,
    stack_fms,
)
from megapath_tpu_torch.parallel.dist import (  # noqa: F401
    DistAlignOut,
    build_dist_align_step,
    shard_arrays,
)
