"""Host-side input: FASTQ/FASTA records (port of ``megapath_tpu.io``)."""
