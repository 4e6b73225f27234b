"""End-to-end pipeline driver.

Replaces the reference's human operator (README.md run order): simulate
-> cut -> initial MSA -> realign -> window -> MaxCorrs -> per-window
clustering -> assessment, with the reference's file contract at every
stage so any stage can be swapped against the C tools.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .config import PipelineConfig
from .models import (assessment, initial_aligner, maxcorr, read_cutter,
                     realigner, resolver, simulator, window)
from .utils import io as rio


@dataclass
class PipelineResult:
    workdir: str
    name: str
    paths: dict = field(default_factory=dict)
    boundaries: list = field(default_factory=list)
    window_results: dict = field(default_factory=dict)
    quality: dict = field(default_factory=dict)
    realign_stats: dict = field(default_factory=dict)


def run_pipeline(cfg: PipelineConfig, workdir: str,
                 progress=print,
                 profile_dir: str | None = None) -> PipelineResult:
    """profile_dir: when set, a jax.profiler trace of the realignment
    phase is written there (the reference's only tracing is wall-clock
    prints, SURVEY.md §5)."""
    from .utils.hostmem import tune_allocator
    tune_allocator()
    os.makedirs(workdir, exist_ok=True)
    ds = simulator.simulate(cfg.simulator)
    paths = ds.write(workdir)
    name = ds.name
    res = PipelineResult(workdir=workdir, name=name, paths=paths)
    progress(f"[sim] {len(ds.reads)} reads, template "
             f"{len(ds.template)}")

    template = ds.template.astype(np.int16)
    reads = [r.astype(np.int16) for r in ds.reads]
    cut = read_cutter.cut_reads(template, reads, cfg.read_cutter)
    seq_path = os.path.join(workdir, name + "_Seq.fasta")
    info_path = os.path.join(workdir, name + "_ReadSeqInfo")
    rio.write_fasta(seq_path, cut.pieces, line_width=None)
    rio.write_readseqinfo(info_path, cut.seqs_per_read)
    paths["seq_fasta"], paths["readseqinfo"] = seq_path, info_path
    progress(f"[cut] {len(cut.pieces)} pieces")

    seqs = [p.astype(np.int16) for p in cut.pieces]
    ia = initial_aligner.build_initial_msa(template, seqs,
                                           cfg.initial_aligner)
    msa_path = os.path.join(workdir, name + "_MSA")
    sc_path = os.path.join(workdir, name + "_SeqClass")
    initial_aligner.write_outputs(ia, msa_path, sc_path)
    paths["msa"], paths["seqclass"] = msa_path, sc_path
    progress(f"[align] {len(ia.rows)} repeat rows, "
             f"width {len(ia.rows[0]) if ia.rows else 0}")

    msa = rio.read_msa(msa_path)
    msareal_path = os.path.join(workdir, name + "_MSAreal")
    log: list = []
    rstats: dict = {}
    if profile_dir:
        import jax
        jax.profiler.start_trace(profile_dir)
    if cfg.realigner.block_rows > 1:
        mesh = None
        if cfg.realigner.mesh_devices > 1:
            from .parallel import sharded
            mesh = sharded.make_mesh(cfg.realigner.mesh_devices)
        best = realigner.realign_batched(
            msa, cfg.realigner, out_path=msareal_path, score_log=log,
            checkpoint_path=os.path.join(workdir, name + "_realign.ckpt"),
            stats=rstats, mode=cfg.realigner.mode,
            kernel=cfg.realigner.kernel, mesh=mesh)
    else:
        best = realigner.realign(msa, cfg.realigner,
                                 out_path=msareal_path, score_log=log)
    if profile_dir:
        import jax
        jax.profiler.stop_trace()
    paths["msareal"] = msareal_path
    res.realign_stats = rstats
    progress(f"[realign] {len(log) - 1} rounds, score "
             f"{log[0]} -> {log[-1]}, width {best.shape[1]}"
             + (f", {rstats['cells_per_s']:.2e} cells/s, route "
                f"{rstats['route']}" if rstats else ""))

    msareal = rio.read_msa(msareal_path)
    bounds = window.window_boundaries(msareal, cfg.window)
    res.boundaries = bounds
    progress(f"[window] boundaries {bounds}")

    # Device path pays off when the row dimension makes the pairwise
    # matmuls the bulk of the work; the exact float64 host path wins
    # for small problems (and always on the CPU platform). The gate is
    # not yet measured on the GPU.
    from . import platform
    use_dev = (platform.on_gpu()
               and msareal.shape[0] >= 512
               and msareal.shape[1] * msareal.shape[0] > 4_000_000)
    if use_dev:
        mc = maxcorr.compute_maxcorrs_device(msareal, cfg.maxcorr)
    else:
        # fast host path: mode-gated prefilter — identical significance
        # decisions, exact values for significant entries; fork workers
        # striped over seed tiles (reference pthread layout)
        mc = maxcorr.compute_maxcorrs(msareal, cfg.maxcorr, fast=True,
                                      threads=min(4, os.cpu_count()
                                                  or 1))
    mc_path = os.path.join(workdir,
                           "MaxCorrsOf_" + os.path.basename(msareal_path))
    rio.write_maxcorrs(mc_path, mc)
    paths["maxcorrs"] = mc_path
    progress(f"[maxcorr] {int((mc > 0).sum())} nonzero of {len(mc)}")

    # Windows are independent (the reference's operator-level
    # parallelism, Window.py + README.md:104-106): resolve concurrently.
    from concurrent.futures import ThreadPoolExecutor
    windows = list(zip(bounds[:-1], bounds[1:]))

    def resolve_one(vb):
        von, bis = vb
        return vb, resolver.resolve_window(msareal, mc, von, bis,
                                           cfg.resolver)

    with ThreadPoolExecutor(max_workers=min(4, len(windows))) as ex:
        for (von, bis), out in ex.map(resolve_one, windows):
            for kind, u in out.items():
                p = os.path.join(workdir, rio.subdivision_path(
                    kind, von, bis, os.path.basename(msareal_path)))
                rio.write_subdivision(p, u)
            res.window_results[(von, bis)] = out
            nclusters = int(out["Kmeans"].max()) + 1
            progress(f"[resolve {von}-{bis}] {nclusters} kmeans "
                     f"clusters")

    # Assessment needs seq2read indices restricted to the MSAreal rows.
    sd = assessment.SimDataset.load(workdir)
    gt = sd.ground_truth_resolution()
    singles = {}
    for (von, bis), out in res.window_results.items():
        q = assessment.resolution_quality(gt, out["Kmeans"])
        singles[(von, bis)] = q
        progress(f"[assess {von}-{bis}] tp={q.truepositives} "
                 f"fp={q.falsepositives}")
    res.quality["singles"] = singles
    if len(res.window_results) >= 1:
        left, right = sd.flanking()
        ordered = [res.window_results[k]["Kmeans"]
                   for k in sorted(res.window_results)]
        _, multi = assessment.multi_step_resolution(left, ordered, right)
        res.quality["multi"] = multi
        progress(f"[assess multi] tp={multi.truepositives} "
                 f"fp={multi.falsepositives} of "
                 f"{len(np.unique(gt))} copies")
    return res
