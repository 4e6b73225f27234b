#!/usr/bin/env python
"""Time the realigner's GPU block step at the production paper shape.

One block of the resident engine: 64 rows x 32768 bases, band 1000,
staircase chunk 128, 139264 columns, at widen 6 (the adapted slack at
paper scale) and 12 (the resident engine's first-sweep slack). For each
staircase fill (the XLA scan and the CUDA kernel) it times the fill
alone and fill + walk, and checks that the two fills agree bit for bit.

With --realign-msa it instead realigns that MSA file (band 1000,
block rows 64, no anneal: the device sweeps of the realign stage) once
per fill, checks that the score trajectories and results are equal,
and reports each stage wall.

Needs a GPU: it fails on any other backend. Prints the platform, the
device kind, the card's name and power limit, then one JSON line.
Times are warm medians over --reps calls; compile time is reported
separately.

    python bench.py [--reps 3] [--widen 6 12]
    python bench.py --realign-msa <MSA file>
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

B, L, W, C, CHUNK = 64, 32768, 1000, 139264, 128


def paper_inputs(seed: int = 0):
    """A seeded block at the paper shape: every row spans the full
    width with a uniform column path (drift 544 columns per chunk, so
    widen 6 covers it)."""
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 4, (B, C)).astype(np.int8)
    counts = np.zeros((C, 6), np.int32)
    for s in range(6):
        counts[:, s] = (msa == s).sum(axis=0)
    counts[:, 0] += 40
    seqs = rng.integers(0, 4, (B, L)).astype(np.int8)
    ways = np.broadcast_to(np.linspace(0, C - 1, L).astype(np.int32),
                           (B, L)).copy()
    lengths = np.full(B, L, np.int32)
    return counts, msa, seqs, ways, lengths


def _time(fn, reps):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        runs.append(time.perf_counter() - t0)
    return out, compile_s, runs


def realign_stage(path: str, fills) -> list:
    """The capstone realign stage's device sweeps, once per fill."""
    from repeatresolver_tpu.config import RealignerConfig
    from repeatresolver_tpu.models import realigner
    from repeatresolver_tpu.utils import io as rio

    msa = rio.read_msa(path)
    cfg = RealignerConfig(bandwidth=W, block_rows=64)
    recs, first = [], None
    for name in fills:
        log: list = []
        stats: dict = {}
        t0 = time.perf_counter()
        out = realigner.realign_batched(msa.copy(), cfg, score_log=log,
                                        stats=stats, mode="staircase",
                                        kernel=name, anneal=False)
        wall = time.perf_counter() - t0
        if first is None:
            first = (log, out)
        same = log == first[0] and np.array_equal(out, first[1])
        rec = dict(fill=name, msa=list(msa.shape), wall_s=wall,
                   rounds=stats["rounds"], route=stats["route"],
                   cells_per_s=stats["cells_per_s"],
                   equal_to_first_fill=same)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--widen", type=int, nargs="+", default=[6, 12])
    ap.add_argument("--fills", nargs="+", default=["xla", "cuda"])
    ap.add_argument("--realign-msa", default=None)
    args = ap.parse_args()

    from repeatresolver_tpu import platform
    platform.setup_compile_cache()
    import jax
    if platform.name() != "gpu":
        print(f"bench.py needs a GPU, found {jax.default_backend()}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    card = platform.card()
    print(f"platform {dev.platform} kind {dev.device_kind} card {card}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if args.realign_msa:
        recs = realign_stage(args.realign_msa, args.fills)
        print(json.dumps({"device": device, "card": card,
                          "realign_stage": recs}))
        return 0 if all(r["equal_to_first_fill"] for r in recs) else 1

    from repeatresolver_tpu.ops import staircase_realign as sr
    from repeatresolver_tpu.ops import cuda_fill as cf
    fills = {"xla": sr.staircase_fill, "cuda": cf.staircase_fill_cuda}
    counts, msa, seqs, ways, lengths = paper_inputs()
    d = [jax.device_put(x) for x in (counts, msa, seqs, ways, lengths)]
    ncols = np.int32(C)
    anf_full = sr.staircase_anf(ways, lengths, W, CHUNK, C)
    bh = W // 2
    eb = np.maximum(-1, ways[:, -1] - bh).astype(np.int32)
    anf_d, eb_d = jax.device_put(anf_full), jax.device_put(eb)
    cells = B * L * W
    results = []
    for widen in args.widen:
        w2 = W + widen * CHUNK
        ref = None
        for name in args.fills:
            fill = fills[name]

            def run_fill():
                return fill(*d, ncols, bandwidth=W, chunk=CHUNK,
                            widen=widen)

            out, c_fill, t_fill = _time(run_fill, args.reps)
            same = None
            if ref is None:
                ref = [np.asarray(o) for o in out]
            else:
                same = all(np.array_equal(r, np.asarray(o))
                           for r, o in zip(ref, out))

            def run_step():
                codes, fband, fanf = run_fill()
                return sr.entry_and_walk(
                    codes, fband, fanf, d[2], anf_d, eb_d, d[4], ncols,
                    cpad=C, bandwidth=w2, chunk=CHUNK)

            _, c_step, t_step = _time(run_step, args.reps)
            rec = dict(fill=name, widen=widen, w2=w2,
                       fill_compile_s=c_fill,
                       fill_s=statistics.median(t_fill),
                       step_compile_s=c_step,
                       step_s=statistics.median(t_step),
                       fill_runs_s=t_fill, step_runs_s=t_step,
                       cells_per_s=cells / statistics.median(t_step),
                       equal_to_first_fill=same)
            print(json.dumps(rec), flush=True)
            results.append(rec)
    print(json.dumps({"device": device,
                      "card": card, "shape": [B, L, W, C, CHUNK],
                      "results": results}))
    return 0 if all(r["equal_to_first_fill"] in (None, True)
                    for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
