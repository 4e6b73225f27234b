#!/usr/bin/env python
"""Prove that the pipeline runs on one NVIDIA GPU, end to end and exact.

    python chip_smoke.py [--seed 0]     # one card: all phases below
    python chip_smoke.py --four          # four cards: only phase 5

Phases (each compares with the repository's plain reference; any
mismatch or error ends the run with a non-zero exit):

 1. device    JAX must report a GPU; prints its kind, the card's name and
              power limit, and the compile-cache directory.
 2. block     a paper-width realign block (64 rows x ~32k bases, ~139k
              columns, band 1000, chunk 128) through the production
              block step of the resident engine, with each staircase
              fill (XLA, CUDA) at widen 6 and 12 — rows, best scores and
              insert lists equal to the native host engine on the exact
              band, bit for bit.
 3. pipeline  the capstone configuration (Tree, d 1%, l 15000, n 10,
              c 30, 10 kb flanks, band 1000, block rows 64, resolver
              cov 20) through pipeline.run_pipeline, the function
              `cli pipeline` calls: every row keeps its bases, fp = 0
              in every window, chain tp = 10 / fp = 0; and the device
              aligner's MSA equals the native engine's on the same
              pieces, byte for byte.
 4. maxcorr   device MaxCorrs against the host float64 scan at 4096 x
              2048 with planted pairs (same significant set, |dZ| within
              the CPU test's 1e-3), and one forced device resolver
              matmul equal to numpy.
 5. --four    the capstone MSA realigned with mesh_devices=4 against one
              card without a mesh (score trajectory and MSA bit-equal),
              and resolve-windows over 4 processes, one card each,
              against one process (subdivision files byte-identical).
              Every part runs in its own process, so no card is ever
              opened by two processes.

Every timing line names the card as nvidia-smi reports it. The last
line of output is the JSON result; nothing is printed there on failure.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

from repeatresolver_tpu import platform  # noqa: E402

BAND, CHUNK, BLOCK = 1000, 128, 64
CAPSTONE = dict(coverage=30, copynumber=10, difference=0.01,
                repeatlength=15000, structure="Tree", flank=10000)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def start_jax(n_devices: int) -> dict:
    """Compile cache, then the device check: a GPU with n devices."""
    cache = platform.setup_compile_cache()
    import jax
    check(platform.name() == "gpu",
          f"JAX reports {jax.default_backend()}, not a GPU")
    devs = jax.devices()
    check(len(devs) >= n_devices, f"{len(devs)} GPUs, need {n_devices}")
    log(f"[device] {devs[0].device_kind} x{len(devs)}; card "
        f"{platform.card()}; compile cache {cache}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ------------------------------------------------------------ 2. block

def make_block_msa(seed: int, rows: int = 256, cons: int = 32600,
                   p_del: float = 0.034, p_ins: float = 0.01275,
                   p_sub: float = 0.02) -> np.ndarray:
    """An MSA slice at paper width: `rows` reads of a `cons`-base
    consensus with substitutions, deletions ('-') and one-base
    insertions, each insertion its own column (~139k columns at the
    defaults), and ragged read ends (' '). Its column path drifts
    ~4.3 columns per base, as paper-scale MSAs do."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, cons).astype(np.int8)
    ins = rng.random((rows, cons)) < p_ins
    per_col = ins.sum(axis=0)
    ccol = np.arange(cons) + np.concatenate([[0], np.cumsum(per_col)[:-1]])
    width = cons + int(per_col.sum())
    msa = np.full((rows, width), 4, np.int8)
    sub = rng.random((rows, cons)) < p_sub
    base = np.where(sub, rng.integers(0, 4, (rows, cons)), tpl[None, :])
    keep = rng.random((rows, cons)) >= p_del
    msa[:, ccol] = np.where(keep, base, 4).astype(np.int8)
    rank = np.cumsum(ins, axis=0) - ins
    r_i, c_i = np.nonzero(ins)
    msa[r_i, ccol[c_i] + 1 + rank[r_i, c_i]] = rng.integers(
        0, 4, len(r_i)).astype(np.int8)
    lo = rng.integers(0, cons // 20, rows)
    hi = cons - rng.integers(1, cons // 20, rows)
    for r in range(rows):
        msa[r, :ccol[lo[r]]] = 5
        msa[r, ccol[hi[r]]:] = 5
    return msa


def block_streams(rows_old: np.ndarray, lpad: int):
    """(seqs, ways, lengths) of a block, padded as the engines pad."""
    b = rows_old.shape[0]
    seqs = np.zeros((b, lpad), np.int8)
    ways = np.zeros((b, lpad), np.int32)
    lengths = np.zeros(b, np.int32)
    for i in range(b):
        pos = np.nonzero(rows_old[i] < 4)[0]
        lengths[i] = len(pos)
        seqs[i, :len(pos)] = rows_old[i, pos]
        ways[i, :len(pos)] = pos
        ways[i, len(pos):] = pos[-1]
    return seqs, ways, lengths


def phase_block(seed: int, card: str, **msa_kw) -> None:
    import jax

    from repeatresolver_tpu.models import realigner
    from repeatresolver_tpu.models import realigner_device as rd
    from repeatresolver_tpu.ops import staircase_realign as sr
    from repeatresolver_tpu.utils import native as nat

    msa = make_block_msa(seed, **msa_kw)
    counts = realigner.symbol_counts(msa).astype(np.int32)
    r, c = msa.shape
    rows_old = msa[:BLOCK]
    lmax = int((rows_old < 4).sum(axis=1).max())
    lpad = rd.length_bucket(lmax)
    seqs, ways, lengths = block_streams(rows_old, lpad)
    starts = np.arange(0, lpad, CHUNK)
    drift = int((ways[:, np.minimum(starts + CHUNK - 1, lpad - 1)]
                 - ways[:, starts]).max())
    log(f"[block] {BLOCK} of {r} rows x {c} columns, {lmax} bases max, "
        f"drift {drift} per {CHUNK}-base chunk")
    check(drift <= 6 * CHUNK, "block drift exceeds widen 6")

    t0 = time.perf_counter()
    res = None
    cap = 512
    while res is None or (res[4] >= cap).any():
        if res is not None:
            cap = int(res[4].max()) * 2
        res = nat.realign_block(counts, np.ascontiguousarray(rows_old),
                                seqs, ways, lengths, BAND, ins_cap=cap)
        check(res is not None, "native host engine unavailable")
    n_rows, n_best, n_iy, n_ib, n_inn = res
    log(f"[block] native exact band on the host: "
        f"{time.perf_counter() - t0:.3f} s, inserts per row max "
        f"{int(n_inn.max())}")
    check(int(n_inn.max()) <= rd.MAX_INSERTS_FETCH, "insert overflow")

    cpad = -(-(c + max(32768, c // 3)) // 1024) * 1024
    msa_p = np.full((BLOCK, cpad), 5, np.int8)
    msa_p[:, :c] = rows_old
    counts_p = np.zeros((cpad, 6), np.int32)
    counts_p[:c] = counts
    order = np.arange(BLOCK, dtype=np.int32)
    anf_full = sr.staircase_anf(ways, lengths, BAND, CHUNK, c)
    eb = np.maximum(-1, ways[np.arange(BLOCK), lengths - 1]
                    - BAND // 2).astype(np.int32)
    for kernel in ("xla", "cuda"):
        for widen in (6, 12):
            step = rd._jits(BAND, CHUNK, widen, lpad, BLOCK,
                            rd.MAX_INSERTS_FETCH, kernel)

            def fresh():
                return (jax.device_put(msa_p), jax.device_put(counts_p),
                        jax.device_put(order), jax.device_put(lengths),
                        np.int32(0), np.int32(c))

            t0 = time.perf_counter()
            compiled = step.lower(*fresh()).compile()
            t_compile = time.perf_counter() - t0
            mem = compiled.memory_analysis()
            m_d, _, out = jax.block_until_ready(compiled(*fresh()))
            new_rows = np.asarray(m_d)[:, :c]
            out = np.asarray(out)
            maxf = rd.MAX_INSERTS_FETCH
            iyb = out[:BLOCK * maxf].reshape(BLOCK, maxf)
            inn = out[BLOCK * maxf:BLOCK * maxf + BLOCK]
            check(np.array_equal(new_rows, n_rows),
                  f"{kernel} w{widen}: rows differ from native")
            check(np.array_equal(inn, n_inn),
                  f"{kernel} w{widen}: insert counts differ")
            for i in range(BLOCK):
                k = int(inn[i])
                check(np.array_equal(iyb[i, :k] >> 2, n_iy[i, :k])
                      and np.array_equal(iyb[i, :k] & 3, n_ib[i, :k]),
                      f"{kernel} w{widen}: insert list of row {i}")
            check(int(out[-1]) == drift, "block step drift")
            w2 = BAND + widen * CHUNK
            fill = sr.fill_for(kernel)
            codes, fband, fanf = fill(
                counts_p, msa_p, seqs, ways, lengths, np.int32(c),
                bandwidth=BAND, chunk=CHUNK, widen=widen)
            best = np.asarray(sr.entry_and_walk(
                codes, fband, fanf, seqs, anf_full, eb, lengths,
                np.int32(c), cpad=cpad, bandwidth=w2, chunk=CHUNK)[1])
            check(np.array_equal(best, n_best),
                  f"{kernel} w{widen}: best scores differ from native")
            times = []
            args = fresh()
            for _ in range(3):
                t0 = time.perf_counter()
                m_d, c_d, o = jax.block_until_ready(compiled(*args))
                times.append(time.perf_counter() - t0)
                args = (m_d, c_d) + args[2:]
            log(f"[block] fill {kernel} widen {widen} (W2 {w2}): rows, "
                f"best, inserts equal to native; step compile "
                f"{t_compile:.1f} s, warm median "
                f"{statistics.median(times):.4f} s {times} on {card}; "
                f"memory: {mem}")


# --------------------------------------------------------- 3. pipeline

def capstone_config(seed: int):
    from repeatresolver_tpu import config as C
    return C.PipelineConfig(
        simulator=C.SimulatorConfig(seed=seed, **CAPSTONE),
        realigner=C.RealignerConfig(bandwidth=BAND, block_rows=BLOCK),
        resolver=C.ResolverConfig(cov=20))


def phase_pipeline(seed: int, card: str, workdir: str) -> None:
    from repeatresolver_tpu import pipeline
    from repeatresolver_tpu.models import initial_aligner as ia
    from repeatresolver_tpu.utils import io as rio

    shutil.rmtree(workdir, ignore_errors=True)
    marks = [("start", time.perf_counter())]

    def progress(msg):
        marks.append((msg.split("]")[0].lstrip("["), time.perf_counter()))
        log(f"[pipeline] {msg}")

    t_all = time.perf_counter()
    res = pipeline.run_pipeline(capstone_config(seed), workdir,
                                progress=progress)
    wall = time.perf_counter() - t_all
    stages = {}
    for (_, t_prev), (name, t) in zip(marks[:-1], marks[1:]):
        key = name.split(" ")[0]
        stages[key] = stages.get(key, 0.0) + t - t_prev
    log(f"[pipeline] stage walls (s) on {card}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
        + f"; total {wall:.1f}; realign route "
        f"{res.realign_stats['route']}, {res.realign_stats['rounds']} "
        f"rounds")
    log("[pipeline] realign sweeps by engine, route and block (rounds, "
        "s): " + "; ".join(
            f"{k}: {n}, {t:.2f}"
            for k, (n, t) in res.realign_stats["sweeps"].items()))

    msa = rio.read_msa(res.paths["msa"])
    real = rio.read_msa(res.paths["msareal"])
    check(msa.shape[0] == real.shape[0], "MSAreal lost rows")
    for i in range(msa.shape[0]):
        check(np.array_equal(msa[i][msa[i] < 4], real[i][real[i] < 4]),
              f"row {i} changed its bases in realignment")
    for (von, bis), q in res.quality["singles"].items():
        check(q.falsepositives == 0, f"window {von}-{bis}: fp "
              f"{q.falsepositives}")
    multi = res.quality["multi"]
    check(multi.truepositives == 10 and multi.falsepositives == 0,
          f"chain tp {multi.truepositives} fp {multi.falsepositives}")
    log(f"[pipeline] every row keeps its bases; fp 0 in "
        f"{len(res.quality['singles'])} windows; chain tp 10 fp 0")

    template = rio.read_template(res.paths["template"]).astype(np.int16)
    pieces = rio.read_fasta(res.paths["seq_fasta"])
    order = np.argsort([len(p) for p in pieces])
    pick = order[np.linspace(0, len(order) - 1, 48).astype(int)]
    seqs = [pieces[i].astype(np.int16) for i in pick]
    cfg = capstone_config(seed).initial_aligner
    t0 = time.perf_counter()
    dev = ia.build_initial_msa(template, seqs, cfg, use_native=False)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = ia.build_initial_msa(template, seqs, cfg, use_native=True)
    t_nat = time.perf_counter() - t0
    check(dev.seqclass == nat.seqclass and len(dev.rows) == len(nat.rows)
          and all(np.array_equal(a, b) for a, b in zip(dev.rows, nat.rows)),
          "device aligner MSA differs from the native engine's")
    log(f"[pipeline] device aligner MSA equals native on {len(seqs)} "
        f"pieces ({len(dev.rows)} rows): device {t_dev:.1f} s, native "
        f"{t_nat:.1f} s on {card}")


# ---------------------------------------------------------- 4. maxcorr

def phase_maxcorr(card: str, rows: int = 4096, cols: int = 2048) -> None:
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from maxcorr_tall_bench import make_tall

    from repeatresolver_tpu.config import MaxCorrConfig
    from repeatresolver_tpu.models import maxcorr
    from repeatresolver_tpu.ops import devmm

    msa = make_tall(rows, cols)
    cfg = MaxCorrConfig()
    cut = cfg.resolved_cutoff(msa.shape[1] * 5)
    t0 = time.perf_counter()
    host = maxcorr.compute_maxcorrs(msa, cfg, fast=True,
                                    threads=min(16, os.cpu_count() or 1))
    t_host = time.perf_counter() - t0
    maxcorr.compute_maxcorrs_device(msa, cfg)        # compile
    t0 = time.perf_counter()
    dev = maxcorr.compute_maxcorrs_device(msa, cfg)
    t_dev = time.perf_counter() - t0
    sig_h, sig_d = host > cut, dev > cut
    dz = float(np.abs(dev - host).max())
    check(np.array_equal(sig_h, sig_d), "significant sets differ")
    check(dz <= 1e-3, f"max |dZ| {dz}")
    log(f"[maxcorr] {rows} x {cols}: {int(sig_h.sum())} significant entries "
        f"equal, max |dZ| {dz:.2e}; host {t_host:.2f} s, device warm "
        f"{t_dev:.2f} s on {card}")

    rng = np.random.default_rng(1)
    a = (rng.random((8192, 648)) < 0.3).astype(np.int8)
    b = (rng.random((6000, 648)) < 0.3).astype(np.int8)
    got = devmm.matmul_t(a, b, force=True)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    check(np.array_equal(got, want), "device matmul differs from numpy")
    log("[maxcorr] forced device resolver matmul 8192 x 6000 x 648 "
        "equals numpy")


# ------------------------------------------------------------ 5. four

def four_mesh(seed: int, workdir: str, rounds: int) -> None:
    """Child process of --four: the capstone MSA realigned on a 4-card
    mesh against one card without one; writes the result and its
    MaxCorrs for the resolve-windows comparison."""
    device = start_jax(4)
    from repeatresolver_tpu import config as C
    from repeatresolver_tpu.models import (initial_aligner, maxcorr,
                                           read_cutter, realigner,
                                           simulator)
    from repeatresolver_tpu.parallel import sharded
    from repeatresolver_tpu.utils import io as rio

    card = platform.card()
    # one insert flush per sweep on both paths: the resident engine's
    # mid-sweep flushes also drop empty columns (a documented deviation
    # from the host-orchestrated mesh path)
    os.environ["RR_FLUSH_CAP"] = str(1 << 30)
    pcfg = capstone_config(seed)
    ds = simulator.simulate(pcfg.simulator)
    tpl = ds.template.astype(np.int16)
    cut = read_cutter.cut_reads(tpl, [x.astype(np.int16) for x in ds.reads],
                                pcfg.read_cutter)
    ia = initial_aligner.build_initial_msa(
        tpl, [p.astype(np.int16) for p in cut.pieces],
        pcfg.initial_aligner, use_native=True)
    msa = np.stack(ia.rows).astype(np.int8)
    cfg = C.RealignerConfig(bandwidth=BAND, block_rows=BLOCK,
                            max_rounds=rounds)
    t0 = time.perf_counter()
    log1: list = []
    one = realigner.realign_batched(msa.copy(), cfg, score_log=log1)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    log4: list = []
    four = realigner.realign_batched(msa.copy(), cfg, score_log=log4,
                                     mesh=sharded.make_mesh(4))
    t_four = time.perf_counter() - t0
    check(log1 == log4, f"mesh trajectory {log4} != one card {log1}")
    check(np.array_equal(one, four), "mesh MSA differs from one card")
    log(f"[four] capstone MSA {msa.shape}, {rounds} rounds at block "
        f"{BLOCK}: mesh of 4 bit-equal to one card (trajectory {log1}); "
        f"one card {t_one:.1f} s, mesh {t_four:.1f} s on {card}")
    path = os.path.join(workdir, "MSAreal_four")
    rio.write_msa(path, one, upper=True)
    rio.write_maxcorrs(os.path.join(workdir, rio.maxcorrs_path(
        "MSAreal_four")), maxcorr.compute_maxcorrs(
        one, pcfg.maxcorr, fast=True, threads=os.cpu_count() or 1))
    print(json.dumps(device), flush=True)


def _run(cmd, env=None, timeout=900) -> str:
    res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=timeout)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr[-4000:])
    check(res.returncode == 0, f"{cmd[:4]} exited {res.returncode}")
    return res.stdout


def run_four(seed: int, workdir: str, rounds: int) -> dict:
    """--four: each part in its own process; this one stays off JAX."""
    shutil.rmtree(workdir, ignore_errors=True)
    one_dir = os.path.join(workdir, "one")
    four_dir = os.path.join(workdir, "four")
    os.makedirs(one_dir)
    out = _run([sys.executable, "-c",
                f"import chip_smoke; chip_smoke.four_mesh({seed}, "
                f"{one_dir!r}, {rounds})"], timeout=1500)
    device = json.loads(out.strip().splitlines()[-1])
    shutil.copytree(one_dir, four_dir)
    cli = [sys.executable, "-m", "repeatresolver_tpu.cli",
           "resolve-windows", "-c", "20"]
    _run(cli + [os.path.join(one_dir, "MSAreal_four")],
         env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        cli + [os.path.join(four_dir, "MSAreal_four"), "--coordinator",
               f"localhost:{port}", "--procs", "4", "--proc-id", str(i)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(4)]
    try:
        for i, p in enumerate(procs):
            text, _ = p.communicate(timeout=900)
            sys.stdout.write(text)
            check(p.returncode == 0, f"resolve process {i} failed")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    subs = sorted(f for f in os.listdir(one_dir) if "Subdivision" in f)
    check(len(subs) > 0 and subs == sorted(
        f for f in os.listdir(four_dir) if "Subdivision" in f),
        "subdivision file sets differ")
    for f in subs:
        with open(os.path.join(one_dir, f), "rb") as a, \
                open(os.path.join(four_dir, f), "rb") as b:
            check(a.read() == b.read(), f"{f} differs")
    log(f"[four] resolve-windows over 4 processes (one card each): "
        f"{len(subs)} subdivision files byte-identical to one process")
    return device


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()
    workdir = os.path.join(HERE, "runs", "chip_smoke")
    if args.four:
        device = run_four(args.seed, os.path.join(workdir, "four"),
                          rounds=1)
    else:
        device = start_jax(1)
        card = platform.card()
        phase_block(args.seed, card)
        phase_pipeline(args.seed, card, os.path.join(workdir, "pipeline"))
        phase_maxcorr(card)
    log(f"card: {platform.card()}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
