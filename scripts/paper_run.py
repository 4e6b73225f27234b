#!/usr/bin/env python
"""Paper-default-scale pipeline driver with stage-level resume.

Runs the BASELINE.md north-star config (Tree d=1% l=30000 n=100 c=40,
/root/reference/README.md:71-73 "run over a weekend") end-to-end with
the same file handoff contract as the reference tools, so every stage
is resumable from its on-disk outputs:

  * stages are skipped when their output files already exist (the
    reference's own caching semantics: MaxCorrs are computed once and
    reloaded, MaxCorrelation.c:1014 / RepeatResolver.c:3972);
  * realignment checkpoints the best MSA every improving round
    (PW_ReAligner.c:1741) plus a binary resume checkpoint, so a killed
    run restarts mid-phase with --resume-realign;
  * per-stage wall times are appended to <workdir>/stage_times.json.

Usage:
  PYTHONPATH=/root/repo JAX_PLATFORMS=cpu python scripts/paper_run.py \
      --workdir runs/paper [--until STAGE] [flags]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

STAGES = ["simulate", "cut", "align", "realign", "window", "maxcorr",
          "resolve", "assess"]


def log_stage(workdir, stage, dt, extra=None):
    rec = {"stage": stage, "wall_s": round(dt, 2),
           "ts": time.strftime("%H:%M:%S")}
    if extra:
        rec.update(extra)
    with open(os.path.join(workdir, "stage_times.json"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"[{rec['ts']}] {stage}: {dt:.1f}s {extra or ''}", flush=True)


def main():
    import faulthandler

    # periodic all-thread stack dumps to stderr: a wedged device
    # dispatch looks like a silent hang otherwise
    faulthandler.dump_traceback_later(900, repeat=True)
    # realign on the GPU compiles one step per (length bucket, widen):
    # persist them across runs and stages
    from repeatresolver_tpu import platform
    platform.setup_compile_cache()
    from repeatresolver_tpu.utils.hostmem import tune_allocator
    tune_allocator()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="runs/paper")
    ap.add_argument("-c", type=int, default=40)
    ap.add_argument("-n", type=int, default=100)
    ap.add_argument("-d", type=float, default=1.0)
    ap.add_argument("-l", type=int, default=30000)
    ap.add_argument("-t", default="Tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--band", type=int, default=1000)
    ap.add_argument("--block-rows", type=int, default=64)
    ap.add_argument("--align-band", type=int, default=5000,
                    help="banded initial alignment (0 = full DP)")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--resolver-cov", type=int, default=0,
                    help="0 = auto from in-window kept rows / n")
    ap.add_argument("--until", default="assess", choices=STAGES)
    args = ap.parse_args()

    from repeatresolver_tpu import config as C
    from repeatresolver_tpu.utils import io as rio

    workdir = args.workdir
    os.makedirs(workdir, exist_ok=True)
    until = STAGES.index(args.until)
    sim_cfg = C.SimulatorConfig(coverage=args.c, copynumber=args.n,
                                difference=args.d / 100.0,
                                repeatlength=args.l, structure=args.t,
                                seed=args.seed)
    name = sim_cfg.dataset_name
    tpl_path = os.path.join(workdir, name + "_Template.fasta")
    reads_path = os.path.join(workdir, name + ".fasta")
    seq_path = os.path.join(workdir, name + "_Seq.fasta")
    info_path = os.path.join(workdir, name + "_ReadSeqInfo")
    msa_path = os.path.join(workdir, name + "_MSA")
    sc_path = os.path.join(workdir, name + "_SeqClass")
    msareal_path = os.path.join(workdir, name + "_MSAreal")
    realign_done = msareal_path + ".done"

    # ---- 1 simulate
    if not os.path.exists(reads_path):
        t0 = time.perf_counter()
        from repeatresolver_tpu.models import simulator
        ds = simulator.simulate(sim_cfg)
        ds.write(workdir)
        log_stage(workdir, "simulate", time.perf_counter() - t0,
                  {"reads": len(ds.reads)})
    if until < 1:
        return

    # ---- 2 cut
    if not os.path.exists(seq_path):
        t0 = time.perf_counter()
        from repeatresolver_tpu.models import read_cutter
        template = rio.read_template(tpl_path).astype(np.int16)
        reads = [r.astype(np.int16) for r in rio.read_fasta(reads_path)]
        cut = read_cutter.cut_reads(template, reads, C.ReadCutterConfig())
        rio.write_fasta(seq_path, cut.pieces, line_width=None)
        rio.write_readseqinfo(info_path, cut.seqs_per_read)
        log_stage(workdir, "cut", time.perf_counter() - t0,
                  {"pieces": len(cut.pieces)})
    if until < 2:
        return

    # ---- 3 align
    if not os.path.exists(msa_path):
        t0 = time.perf_counter()
        from repeatresolver_tpu.models import initial_aligner
        template = rio.read_template(tpl_path).astype(np.int16)
        seqs = [s.astype(np.int16) for s in rio.read_fasta(seq_path)]
        ia = initial_aligner.build_initial_msa(
            template, seqs,
            C.InitialAlignerConfig(band=args.align_band))
        initial_aligner.write_outputs(ia, msa_path, sc_path)
        log_stage(workdir, "align", time.perf_counter() - t0,
                  {"rows": len(ia.rows),
                   "width": len(ia.rows[0]) if ia.rows else 0})
    if until < 3:
        return

    # ---- 4 realign
    if not os.path.exists(realign_done):
        t0 = time.perf_counter()
        from repeatresolver_tpu.models import realigner
        msa = rio.read_msa(msa_path)
        print(f"realign start: {msa.shape[0]} rows x {msa.shape[1]} "
              f"cols", flush=True)
        log: list = []
        rstats: dict = {}
        cfg = C.RealignerConfig(bandwidth=args.band,
                                block_rows=args.block_rows)
        realigner.realign_batched(
            msa, cfg, out_path=msareal_path, score_log=log,
            checkpoint_path=os.path.join(workdir, name + "_realign.ckpt"),
            resume=True, stats=rstats,
            score_log_path=os.path.join(workdir, name + "_scorelog"))
        with open(realign_done, "w") as f:
            json.dump({"rounds": rstats.get("rounds"),
                       "cells_per_s": rstats.get("cells_per_s")}, f)
        log_stage(workdir, "realign", time.perf_counter() - t0, rstats)
    if until < 4:
        return

    # ---- 5 window
    from repeatresolver_tpu.models import window
    msareal = rio.read_msa(msareal_path)
    bounds = window.window_boundaries(msareal, C.WindowConfig())
    print(f"windows: {bounds}", flush=True)
    if until < 5:
        return

    # ---- 6 maxcorr (cached on disk like the reference)
    mc_path = os.path.join(workdir,
                           "MaxCorrsOf_" + os.path.basename(msareal_path))
    if not os.path.exists(mc_path):
        t0 = time.perf_counter()
        from repeatresolver_tpu.models import maxcorr
        mc = maxcorr.compute_maxcorrs(msareal, C.MaxCorrConfig(),
                                      fast=True, threads=args.threads,
                                      checkpoint_path=mc_path + ".ckpt")
        rio.write_maxcorrs(mc_path, mc)
        log_stage(workdir, "maxcorr", time.perf_counter() - t0,
                  {"nonzero": int((mc > 0).sum())})
    mc = rio.read_maxcorrs(mc_path)
    if until < 6:
        return

    # ---- 7 resolve per window (each window resumable on its own files)
    from repeatresolver_tpu.models import resolver
    windows = list(zip(bounds[:-1], bounds[1:]))
    results = {}
    for von, bis in windows:
        paths = {k: os.path.join(workdir, rio.subdivision_path(
            k, von, bis, os.path.basename(msareal_path)))
            for k in ("Dropoff", "RelDrop", "Kmeans")}
        if all(os.path.exists(p) for p in paths.values()):
            results[(von, bis)] = {k: np.array(rio.read_ints(p))
                                   for k, p in paths.items()}
            continue
        t0 = time.perf_counter()
        cov = args.resolver_cov
        if cov == 0:
            keep = (msareal[:, von] < 5) & (msareal[:, bis] < 5)
            cov = max(4, int(keep.sum()) // args.n)
        out = resolver.resolve_window(msareal, mc, von, bis,
                                      C.ResolverConfig(cov=cov))
        for kind, u in out.items():
            rio.write_subdivision(paths[kind], u)
        results[(von, bis)] = out
        log_stage(workdir, f"resolve_{von}_{bis}",
                  time.perf_counter() - t0,
                  {"cov": cov,
                   "kmeans_clusters": int(out["Kmeans"].max()) + 1})
    if until < 7:
        return

    # ---- 8 assess
    t0 = time.perf_counter()
    from repeatresolver_tpu.models import assessment
    sd = assessment.SimDataset.load(workdir)
    gt = sd.ground_truth_resolution()
    summary = {}
    for (von, bis), out in sorted(results.items()):
        q = assessment.resolution_quality(gt, out["Kmeans"])
        summary[f"{von}_{bis}"] = {"tp": q.truepositives,
                                   "fp": q.falsepositives}
        print(f"[assess {von}-{bis}] tp={q.truepositives} "
              f"fp={q.falsepositives}", flush=True)
    left, right = sd.flanking()
    ordered = [results[k]["Kmeans"] for k in sorted(results)]
    _, multi = assessment.multi_step_resolution(left, ordered, right)
    summary["multi"] = {"tp": multi.truepositives,
                        "fp": multi.falsepositives,
                        "copies": int(len(np.unique(gt)))}
    print(f"[assess multi] tp={multi.truepositives} "
          f"fp={multi.falsepositives} of {len(np.unique(gt))}",
          flush=True)
    with open(os.path.join(workdir, "assessment.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log_stage(workdir, "assess", time.perf_counter() - t0, summary.get(
        "multi"))


if __name__ == "__main__":
    main()
