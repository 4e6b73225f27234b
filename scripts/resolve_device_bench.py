#!/usr/bin/env python
"""Measure the resolver's devmm routing on a GPU at one paper-scale
window against the host BLAS path.

Runs resolve_window twice on the same paper-scale inputs — once with
RR_RESOLVER_DEVICE=1 (clique/kmeans matmuls on the accelerator via
ops/devmm, reference math RepeatResolver.c:1634-1690, 2604-2821) and
once with RR_RESOLVER_DEVICE=0 (numpy BLAS) — in subprocesses so each
leg picks its backend cleanly, and asserts the three subdivision
outputs are byte-identical (devmm is exact int32, so placement must
not change a single assignment).

Usage:
  python scripts/resolve_device_bench.py \
      [--workdir runs/paper] [--von V --bis B] [--out runs/resolve_devmm.json]
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

LEG = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from repeatresolver_tpu.utils.hostmem import tune_allocator
tune_allocator()
from repeatresolver_tpu import config as C
from repeatresolver_tpu.models import resolver
from repeatresolver_tpu.utils import io as rio
t0 = time.perf_counter()
msa = rio.read_msa({msa!r})
mc = rio.read_maxcorrs({mc!r})
load_s = time.perf_counter() - t0
von, bis = {von}, {bis}
keep = (msa[:, von] < 5) & (msa[:, bis] < 5)
cov = max(4, int(keep.sum()) // {n})
t0 = time.perf_counter()
out = resolver.resolve_window(msa, mc, von, bis,
                              C.ResolverConfig(cov=cov))
wall = time.perf_counter() - t0
for kind, u in out.items():
    rio.write_subdivision({tag!r} + kind, u)
import jax
print("LEG", {tag!r}, round(load_s, 1), round(wall, 2),
      jax.default_backend(), flush=True)
"""


def run_leg(tag, dev, msa, mc, von, bis, n):
    env = dict(os.environ)
    env["RR_RESOLVER_DEVICE"] = "1" if dev else "0"
    if not dev:
        # host leg: keep jax off the chip entirely
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = REPO
    code = LEG.format(repo=REPO, msa=msa, mc=mc, von=von, bis=bis,
                      n=n, tag=tag)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=3600)
    if res.returncode != 0:
        print(res.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"{tag} leg failed")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("LEG")][0].split()
    return {"load_s": float(line[2]), "resolve_s": float(line[3]),
            "backend": line[4],
            "subprocess_s": round(time.perf_counter() - t0, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="runs/paper")
    ap.add_argument("--name", default="Tree_1perc_30000kb_MSAreal")
    ap.add_argument("--von", type=int, default=0)
    ap.add_argument("--bis", type=int, default=0)
    ap.add_argument("-n", type=int, default=100)
    ap.add_argument("--out", default="runs/resolve_devmm.json")
    args = ap.parse_args()

    msa_path = os.path.join(args.workdir, args.name)
    mc_path = os.path.join(args.workdir, "MaxCorrsOf_" + args.name)
    von, bis = args.von, args.bis
    if not bis:
        # first window of the standard 6-section split
        import jax
        jax.config.update("jax_platforms", "cpu")
        from repeatresolver_tpu import config as C
        from repeatresolver_tpu.models import window
        from repeatresolver_tpu.utils import io as rio
        from repeatresolver_tpu.utils.hostmem import tune_allocator
        tune_allocator()
        msa = rio.read_msa(msa_path)
        bounds = window.window_boundaries(msa, C.WindowConfig())
        von, bis = bounds[0], bounds[1]
        del msa
    print(f"window {von}-{bis}", flush=True)

    tag_d = os.path.join(args.workdir, "devmm_bench_dev_")
    tag_h = os.path.join(args.workdir, "devmm_bench_host_")
    dev = run_leg(tag_d, True, msa_path, mc_path, von, bis, args.n)
    host = run_leg(tag_h, False, msa_path, mc_path, von, bis, args.n)
    equal = all(
        open(tag_d + k, "rb").read() == open(tag_h + k, "rb").read()
        for k in ("Dropoff", "RelDrop", "Kmeans"))
    summary = {"window": [von, bis], "device": dev, "host": host,
               "speedup": round(host["resolve_s"] / dev["resolve_s"],
                                2),
               "subdivisions_byte_equal": equal}
    print(json.dumps(summary))
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    if not equal:
        raise SystemExit("subdivision outputs differ between legs")


if __name__ == "__main__":
    main()
