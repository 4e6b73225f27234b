#!/usr/bin/env python
"""Sweep-wall vs virtual mesh size: the reachable scaling proxy.

A CPU-only proxy for multi-card scaling: this measures the production
mesh realign path (BatchedRealigner(mesh=), rows sharded per block,
count delta merged by psum —
parallel/sharded.sharded_block_realign) on the virtual CPU mesh at
sizes {1, 2, 4, 8} over a FIXED MSA and block configuration.

On a shared-core CPU mesh the devices do not add compute, so the
interesting quantity is the OVERHEAD curve: wall(n)/wall(1) isolates
partition + collective + padding cost that real cards would also pay
(the compute term is constant). The per-block psum volume is reported
analytically: every block merges one [cpad, 6] int32 delta per device.

Each mesh size runs in its own subprocess (fresh XLA runtime with
--xla_force_host_platform_device_count=<n>). Results append to
--out (default runs/mesh_scaling.json).

Usage: python scripts/mesh_scaling.py
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SNIPPET = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from repeatresolver_tpu import config as C
from repeatresolver_tpu.models import realigner
from repeatresolver_tpu.parallel import sharded

n = {n}
rng = np.random.default_rng(3)
rows, tlen = {rows}, {tlen}
tpl = rng.integers(0, 4, tlen)
msa = np.full((rows, tlen), 5, np.int8)
for r in range(rows):
    lo = rng.integers(0, 25); hi = tlen - rng.integers(0, 25)
    seg = tpl[lo:hi].copy()
    sub = rng.random(len(seg)) < 0.08
    seg[sub] = rng.integers(0, 4, sub.sum())
    gap = rng.random(len(seg)) < 0.10
    seg[gap] = 4
    msa[r, lo:hi] = seg

mesh = sharded.make_mesh(n) if n > 1 else None
log = []
stats = {{}}
eng_msa = msa.copy()
# one compile+warm pass, then timed convergence run
t0 = time.perf_counter()
out = realigner.realign_batched(
    eng_msa, C.RealignerConfig(bandwidth={band}, block_rows={block}),
    score_log=log, stats=stats, mode="staircase",
    kernel="xla", mesh=mesh)
wall = time.perf_counter() - t0
blocks = -(-rows // {block})
cpad = 512
while cpad < msa.shape[1]:
    cpad *= 2
psum_bytes_per_block = cpad * 6 * 4
print(json.dumps({{
    "mesh": n, "wall_s": round(wall, 2),
    "rounds": stats.get("rounds"),
    "cells_per_s": round(stats.get("cells_per_s", 0)),
    "best": list(min(log)),
    "trajectory": [list(p) for p in log],
    "blocks_per_sweep": blocks,
    "psum_bytes_per_block": psum_bytes_per_block,
}}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/mesh_scaling.json")
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--tlen", type=int, default=2000)
    ap.add_argument("--band", type=int, default=256)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    results = []
    for n in [int(s) for s in args.sizes.split(",")]:
        walls = []
        rec = None
        for rep in range(args.repeats):
            code = SNIPPET.format(repo=REPO, n=n, rows=args.rows,
                                  tlen=args.tlen, band=args.band,
                                  block=args.block)
            env = dict(os.environ)
            env["JAX_PLATFORMS"] = "cpu"
            env["PYTHONPATH"] = REPO
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={max(n, 1)}")
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-c", code], env=env,
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stderr[-3000:], file=sys.stderr)
                raise SystemExit(f"mesh={n} failed")
            line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith("{")][-1]
            rec = json.loads(line)
            walls.append(rec["wall_s"])
            print(f"mesh={n} rep={rep}: wall {rec['wall_s']}s "
                  f"(subprocess {time.perf_counter() - t0:.0f}s)",
                  flush=True)
        rec["wall_s"] = min(walls)
        rec["walls_all"] = walls
        results.append(rec)

    # trajectory parity across mesh sizes (bit-equal by design)
    trajs = {r["mesh"]: r["trajectory"] for r in results}
    base = trajs[min(trajs)]
    parity = all(t == base for t in trajs.values())
    for r in results:
        del r["trajectory"]
    out = {"config": vars(args), "results": results,
           "trajectory_bit_equal_across_sizes": parity,
           "overhead_vs_mesh1": [
               round(r["wall_s"] / results[0]["wall_s"], 3)
               for r in results]}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
