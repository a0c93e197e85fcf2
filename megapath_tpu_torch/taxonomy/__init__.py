"""NCBI taxonomy and Kraken reports (port of ``megapath_tpu.taxonomy``)."""
