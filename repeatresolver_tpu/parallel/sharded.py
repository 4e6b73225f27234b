"""Multi-chip sharding of the pipeline's two heavy phases.

The reference's only parallelism is single-node pthreads (SURVEY.md
§2.3). The device-mesh equivalents:

  * realignment sweeps: rows data-parallel over the mesh 'rows' axis,
    column histogram replicated; after each block the one-hot count
    deltas are psum'd across the devices — the collective analogue of
    the reference's disjoint-stripe thread writes.
  * MaxCorrs: columns sharded; each device computes significance for
    its seed-column shard against the full group matrix; the final
    elementwise max over devices mirrors the reference's thread merge
    (MaxCorrelation.c:881-891) as a pmax.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from ..ops import banded_realign as br


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D 'rows' mesh over the first n devices of the default
    backend; raises when it has fewer."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} {devs[0].platform} devices, have "
                         f"{len(devs)}")
    return Mesh(np.array(devs[:n]), ("rows",))


def sharded_realign_step(mesh: Mesh, ncols: int, bandwidth: int):
    """One data-parallel realignment block step: banded DP + backtrack
    per row shard, counts delta psum'd over the mesh.

    Returns a jitted fn(counts, rows_old, seqs, ways, lengths) ->
    (new_rows [R, C], new_counts [C, 6]).
    """

    def local_step(counts, rows_old, seqs, ways, lengths):
        codes, fband, fanf = br.banded_fill(
            counts, rows_old, seqs, ways, lengths,
            jnp.int32(ncols), bandwidth=bandwidth)
        bh = bandwidth // 2
        anf_full = jnp.maximum(0, ways - bh)
        last_way = jnp.take_along_axis(
            ways, jnp.maximum(lengths - 1, 0)[:, None], axis=1)[:, 0]
        entry_bound = jnp.maximum(-1, last_way - bh)
        new_rows, best, iy, ib, inn = br.entry_and_backtrack(
            codes, fband, fanf, seqs, anf_full, entry_bound, lengths,
            jnp.int32(ncols), cpad=rows_old.shape[1],
            bandwidth=bandwidth)

        def hist(rows):
            return (rows[:, :, None] ==
                    jnp.arange(6, dtype=rows.dtype)[None, None, :]
                    ).sum(axis=0).astype(jnp.int32)

        delta = hist(new_rows) - hist(rows_old)
        delta = jax.lax.psum(delta, "rows")
        return new_rows, counts + delta, best

    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P("rows"), P("rows"), P("rows"), P("rows")),
        out_specs=(P("rows"), P(), P("rows")),
        check_vma=False)
    return jax.jit(fn)


def sharded_block_realign(mesh: Mesh, bandwidth: int, mode: str = "exact",
                          chunk: int = 256, widen: int = 1,
                          kernel: str = "xla"):
    """Production mesh step for BatchedRealigner: the block's rows are
    sharded over the mesh 'rows' axis, the column histogram is
    replicated, and the count delta is psum'd across the devices — the
    collective analogue of the reference's disjoint-stripe thread
    writes with merge-by-sum (MaxCorrelation.c thread pattern;
    PW_ReAligner stripes).

    The DP math is the identical fill + walk the single-device engine
    runs (staircase: the fill `kernel` names, ops/staircase_realign.
    fill_for), so the block-Jacobi trajectory is bit-equal to the
    unsharded path (tested in tests/test_sharded.py).

    Returns a jitted fn(counts [Cp,6], rows_old [B,Cp], seqs [B,L],
    ways [B,L], lengths [B], anf_full [B,L], entry_bound [B],
    valid [B], ncols) -> (new_rows, iy, ib, inn, delta[Cp,6]) with B
    divisible by the mesh size; rows with valid=0 (padding duplicates)
    are excluded from the delta.
    """
    from ..ops import staircase_realign as sr
    w_codes = bandwidth + (widen * chunk if mode == "staircase" else 0)
    fill = sr.fill_for(kernel)

    def local(counts, rows_old, seqs, ways, lengths, anf_full,
              entry_bound, valid, ncols):
        if mode == "staircase":
            codes, fband, fanf = fill(
                counts, rows_old, seqs, ways, lengths, ncols,
                bandwidth=bandwidth, chunk=chunk, widen=widen)
            new_rows, best, iy, ib, inn = sr.entry_and_walk(
                codes, fband, fanf, seqs, anf_full, entry_bound,
                lengths, ncols, cpad=rows_old.shape[1],
                bandwidth=w_codes, chunk=chunk)
        else:
            codes, fband, fanf = br.banded_fill(
                counts, rows_old, seqs, ways, lengths, ncols,
                bandwidth=bandwidth)
            new_rows, best, iy, ib, inn = br.entry_and_backtrack(
                codes, fband, fanf, seqs, anf_full, entry_bound,
                lengths, ncols, cpad=rows_old.shape[1],
                bandwidth=w_codes)
        sym = jnp.arange(6, dtype=jnp.int32)[None, None, :]
        rowmask = (valid > 0)[:, None, None]
        colmask = (jnp.arange(rows_old.shape[1]) < ncols)[None, :, None]

        def hist(rows):
            eq = rows.astype(jnp.int32)[:, :, None] == sym
            return (eq & rowmask & colmask).sum(axis=0).astype(jnp.int32)

        delta = jax.lax.psum(hist(new_rows) - hist(rows_old), "rows")
        return new_rows, iy, ib, inn, delta

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("rows"), P("rows"), P("rows"), P("rows"),
                  P("rows"), P("rows"), P("rows"), P()),
        out_specs=(P("rows"), P("rows"), P("rows"), P("rows"), P()),
        check_vma=False)
    return jax.jit(fn)


def sharded_maxcorr_scores(mesh: Mesh):
    """Column-sharded group-intersection scores: each device holds a
    shard of seed groups, matmuls against the replicated full group
    matrix, and the global per-group max merges with a pmax.

    This is the collective primitive; the PRODUCTION sharded MaxCorrs —
    the full gated significance scan (seed gates, >=gap pair distance,
    coverage break, per-group max, pmax thread-merge,
    MaxCorrelation.c:744-908) striped over the mesh — is
    models/maxcorr.compute_maxcorrs_device(mesh=...), value-tested
    against the host scan in tests/test_sharded.py.

    Returns jitted fn(groups_shard [C5/n, R], groups_full [C5, R],
    coverage_full [C, R]) -> (schnitt [C5/n, C5], global_max scalar).
    """

    def local(groups_shard, groups_full):
        schnitt = jnp.dot(groups_shard, groups_full.T,
                          preferred_element_type=jnp.float32)
        gmax = jax.lax.pmax(schnitt.max(), "rows")
        return schnitt, gmax

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("rows"), P()),
        out_specs=(P("rows"), P()))
    return jax.jit(fn)


def dryrun(n_devices: int, bandwidth: int = 128) -> None:
    """Compile + execute one full sharded step on tiny shapes."""
    mesh = make_mesh(n_devices)
    rng = np.random.default_rng(0)
    rows_per_dev = 2
    r = n_devices * rows_per_dev
    c, l, w = 512, 256, bandwidth
    msa = np.full((r, c), 5, np.int8)
    for k in range(r):
        seg = rng.integers(0, 4, c - 40).astype(np.int8)
        gaps = rng.random(c - 40) < 0.1
        seg[gaps] = 4
        msa[k, 20:c - 20] = seg
    counts = np.zeros((c, 6), np.int32)
    for s in range(6):
        counts[:, s] = (msa == s).sum(axis=0)
    lengths = np.zeros(r, np.int32)
    seqs = np.zeros((r, l), np.int8)
    ways = np.zeros((r, l), np.int32)
    for k in range(r):
        pos = np.nonzero(msa[k] < 4)[0][:l]
        lengths[k] = len(pos)
        seqs[k, :len(pos)] = msa[k][pos]
        ways[k, :len(pos)] = pos
        if len(pos) < l:
            ways[k, len(pos):] = pos[-1] if len(pos) else 0

    step = sharded_realign_step(mesh, ncols=c, bandwidth=w)
    new_rows, new_counts, best = step(counts, msa, seqs, ways, lengths)
    new_rows.block_until_ready()
    assert new_rows.shape == (r, c)
    assert new_counts.shape == (c, 6)

    # column-sharded MaxCorr intersections
    c5 = 128 * n_devices
    groups = (rng.random((c5, r)) < 0.3).astype(np.float32)
    mm = sharded_maxcorr_scores(mesh)
    schnitt, gmax = mm(groups, groups)
    schnitt.block_until_ready()
    assert schnitt.shape == (c5, c5)

    # production sharded MaxCorrs: the full gated scan striped over the
    # mesh (pmax thread-merge) must equal the single-device device scan
    # and the host scan within f32 tolerance.
    from ..config import MaxCorrConfig
    from ..models import maxcorr as mcx

    mc_cfg = MaxCorrConfig(mincov=8)
    host_mc = mcx.compute_maxcorrs(msa[:, :256], mc_cfg, native="never")
    mesh_mc = mcx.compute_maxcorrs_device(msa[:, :256], mc_cfg,
                                          tile=64, mesh=mesh)
    assert np.abs(mesh_mc - host_mc).max() < 1e-3

    # production mesh path: realign a real synthetic MSA to convergence
    # through BatchedRealigner's sharded block sweeps and assert the
    # trajectory is bit-equal to the single-device block-Jacobi run and
    # the counts invariant holds (W_Con_Checker semantics).
    from ..config import RealignerConfig
    from ..models import realigner

    tlen = 240
    tpl = rng.integers(0, 4, tlen)
    msa2 = np.full((16, tlen), 5, np.int8)
    for k in range(16):
        lo = int(rng.integers(0, 20))
        hi = tlen - int(rng.integers(0, 20))
        seg = tpl[lo:hi].copy()
        sub = rng.random(len(seg)) < 0.08
        seg[sub] = rng.integers(0, 4, int(sub.sum()))
        gap = rng.random(len(seg)) < 0.10
        seg[gap] = 4
        msa2[k, lo:hi] = seg
    cfg = RealignerConfig(bandwidth=96, block_rows=16)
    log_single: list = []
    ref = realigner.realign_batched(msa2.copy(), cfg,
                                    score_log=log_single, mode="exact",
                                    kernel="xla")
    log_mesh: list = []
    out = realigner.realign_batched(msa2.copy(), cfg,
                                    score_log=log_mesh, mode="exact",
                                    mesh=mesh)
    assert log_mesh == log_single, (log_mesh, log_single)
    np.testing.assert_array_equal(out, ref)
    realigner.validate_counts(out, realigner.symbol_counts(out))
