"""Stage timing (port of ``megapath_tpu.utils``)."""
