"""Read and coverage filters: bbduk, SPIKE (port of ``megapath_tpu.filters``)."""
