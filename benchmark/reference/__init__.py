"""The benchmark's plain reference of the mapper under test: plain NumPy
and PyTorch, imports neither JAX nor either sigfish package.

host      picoamps, events, the direct-RNA polyA end, the query window
tracks    the expected-level tracks of the contigs
sdtw      the exact subsequence DTW and the backtrack
paf       candidates, ranking and the PAF line
mapper    all of it for a set of reads
"""
