"""Read reassignment (port of ``megapath_tpu.classify``)."""
