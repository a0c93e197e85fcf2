"""The seconds set-up spent packing the shards' tables on the host and
putting them on the card: the program's counters
``parallel.spmd_full.pack_ms`` and ``upload_ms`` (host milliseconds in
``place_spmd_full_inputs``, the upload's up to a synchronise of the card),
summed and read as the process's totals. A program without the counters,
or one that never placed a shard, reads nothing."""

import sys


def seconds(pack_ms: float, upload_ms: float):
    if not pack_ms and not upload_ms:
        return None
    return (pack_ms + upload_ms) / 1e3


def read(ctx):
    step = sys.modules.get("megapath_tpu_torch.parallel.spmd_full")
    return seconds(getattr(step, "pack_ms", 0.0), getattr(step, "upload_ms", 0.0))
