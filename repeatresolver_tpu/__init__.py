"""repeatresolver_tpu — a JAX repeat-resolution engine.

A from-scratch JAX re-architecture of the capabilities of
PhilippBongartz/RepeatResolver:

  simulate -> cut -> initial-align -> realign (sum-of-pairs MSA refinement)
           -> column statistics (MaxCorrs) -> windowed clustering
           -> flank connection -> assessment

Layout:
  models/    pipeline stages as array programs (simulator, read_cutter,
             initial_aligner, realigner, maxcorr, resolver, window,
             assessment)
  ops/       compute kernels (wavefront edit-distance DP, banded and
             staircase realign DP with a CUDA fill, bit-group
             intersections as integer matmuls, log-space
             hypergeometric tails)
  platform   the one GPU/CPU route decision
  parallel/  mesh construction, sharded sweeps, collectives
  utils/     file formats (the reference's on-disk contract), checkpoints

Symbols follow the reference encoding throughout:
  0=a 1=c 2=g 3=t 4='-' (alignment gap) 5=' ' (coverage gap)
"""

__version__ = "0.1.0"

A, C, G, T, GAP, SPACE = 0, 1, 2, 3, 4, 5
SYMBOLS = "acgt- "
SYMBOLS_UPPER = "ACGT- "
