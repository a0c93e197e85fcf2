"""The one-program backend of stage 2: the whole alignment engine run on
the device for each (data, shard) cell of a grid of torch devices
(``spmd_full``)."""

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
