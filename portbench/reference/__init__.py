"""The plain reference that decides ``correct``: where each sampled read
end aligns in each shard, worked out from the shard's text and the reads
by a k-mer scan and a plain Smith-Waterman (``align.py``). It imports
nothing of ``megapath_tpu_torch`` or the JAX package and takes nothing
the program made.
"""
