"""Shard packing and the FM index (port of ``megapath_tpu.index``)."""
