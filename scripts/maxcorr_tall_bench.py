#!/usr/bin/env python
"""Tall-MSA MaxCorrs head-to-head: device scan vs host paths.

Measures whether the device MaxCorrs path beats the host path on tall
MSAs. The device scan's work is int8 one-hot matmuls over the rows
axis (models/maxcorr.py:246), so its advantage grows with row count;
the host bitset scan pays
r/64 words per intersection. This script times, on a synthetic tall
MSA with planted correlated pairs (the shape regime of real transposon
families: thousands of rows, few thousand columns):

  * compute_maxcorrs        exact host scan (numpy, fast gates)
  * MaxCorrBitsets.scan     native C++ banded-bitset scan (N threads)
  * compute_maxcorrs_device single-dispatch device scan (real chip)

and checks device-vs-host cutoff agreement. Usage:
  python scripts/maxcorr_tall_bench.py [rows] [cols] [threads]
(run on a GPU for the device leg.)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from repeatresolver_tpu.config import MaxCorrConfig
from repeatresolver_tpu.models import maxcorr
from repeatresolver_tpu.utils import native


def make_tall(r, c, seed=0):
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 4, (r, c)).astype(np.int8)
    # coverage-gap tails like a real MSA (rows start/end with spaces)
    starts = rng.integers(0, c // 8, r)
    ends = rng.integers(0, c // 8, r)
    for i in range(r):
        msa[i, : starts[i]] = 5
        msa[i, c - ends[i]:] = 5
    # planted co-occurring deviations (what MaxCorrs exists to find)
    for k in range(24):
        a = rng.integers(c // 8, c // 2)
        b = rng.integers(a + 40, c - c // 8)
        mask = rng.random(r) < 0.3
        msa[mask, a] = 0
        msa[mask, b] = 1
    return msa


def main():
    r = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    c = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    threads = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    msa = make_tall(r, c)
    cfg = MaxCorrConfig()
    cut = cfg.resolved_cutoff(c * 5)
    print(f"tall MSA {r}x{c}, cutoff {cut:.2f}", flush=True)

    # native C++ banded-bitset scan (the production host path)
    t0 = time.perf_counter()
    bits = native.MaxCorrBitsets(msa)
    mc_nat = np.zeros(c * 5, np.float64)
    bits.scan(mc_nat, 0, c, cfg.mincov, cfg.min_col_gap, r,
              cfg.majority_filter, True, threads)
    t_nat = time.perf_counter() - t0
    print(f"native-cpu x{threads}: {t_nat:.1f}s", flush=True)

    # device single-dispatch scan (compile excluded: report warm rate)
    import jax
    backend = jax.default_backend()
    t0 = time.perf_counter()
    mc_dev = maxcorr.compute_maxcorrs_device(msa, cfg)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    mc_dev = maxcorr.compute_maxcorrs_device(msa, cfg)
    t_dev = time.perf_counter() - t0
    print(f"device [{backend}]: {t_dev:.1f}s warm "
          f"({t_cold:.1f}s cold)", flush=True)

    agree = np.array_equal(mc_nat > cut, mc_dev > cut)
    err = float(np.abs(mc_nat - mc_dev).max())
    print(f"cutoff agreement: {agree}, max |dZ| = {err:.3g}", flush=True)
    print(f"speedup device vs native-cpu x{threads}: "
          f"{t_nat / t_dev:.2f}x", flush=True)


if __name__ == "__main__":
    main()
