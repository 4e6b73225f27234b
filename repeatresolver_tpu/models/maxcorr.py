"""Per-(column,symbol) maximum correlation significance (MaxCorrs).

Re-architecture of MaxCorrelation.c. The reference's row bitsets +
popcount loops become dense one-hot matrices whose intersections are
matrix products (|A∩B| = binary inner product); the
hypergeometric tail is the vectorized log-space implementation in
ops/hypergeom.py.

Reproduced semantics (the reference DEFAULT path is the threaded variant
Parallel_AllMaxCorrsRechner, used even with -p 1):
  * seed gates: mincov/4 < |G| < maxgroup AND majority-deviation filter
    baseno > Coverage/2 (MaxCorrelation.c:798-802); partner gate is the
    size gate only (:817)
  * partners at column distance >= 20, scanned ascending with a hard
    break at the first jj whose shared coverage with ii drops below
    mincov (:804-810) — later columns are skipped even if their shared
    coverage recovers
  * Z = PositiveSignificance with coverage-intersected gr1/gr2 and the
    98 -> 98+F1 cap (:421-434); MaxCorrs is the elementwise max over
    both sides of each ordered pair (:822-823)
  * the threaded variant computes but never applies the count<5
    suppression of the serial variant (:629-634) — so neither do we
"""
from __future__ import annotations

import os

import numpy as np

from ..config import MaxCorrConfig
from ..ops import hypergeom as hg


def group_matrices(msa: np.ndarray):
    """One-hot views: groups [C*5, R] float32, coverage [C, R] float32,
    sizes [C, 5], covcount [C]."""
    msa = np.asarray(msa)
    r, c = msa.shape
    groups = np.zeros((c, 5, r), np.float32)
    for s in range(5):
        groups[:, s, :] = (msa.T == s)
    coverage = (msa.T < 5).astype(np.float32)      # [C, R]
    sizes = groups.sum(axis=2).astype(np.int64)    # [C, 5]
    covcount = coverage.sum(axis=1).astype(np.int64)
    return groups.reshape(c * 5, r), coverage, sizes, covcount


_FORK_STATE: dict = {}


def _scan_seed_tiles(i0_list):
    """Worker: scan the given seed-tile rows, return a local maxcorrs.
    The reference's threaded variant stripes seed columns the same way
    and merges with elementwise max (MaxCorrelation.c:796, 881-891).
    BLAS is pinned to one thread per worker — the serial path already
    saturates cores through multithreaded matmuls, so workers must not
    multiply that."""
    s = _FORK_STATE
    try:
        from threadpoolctl import threadpool_limits
        with threadpool_limits(limits=1):
            return _tile_scan(i0_list, s["groups"], s["coverage"],
                              s["sizes_flat"], s["seed_ok"],
                              s["partner_ok"], s["c"], s["mincov"],
                              s["gap"], s["tile"], s["matmul"],
                              s["fast"])
    except ImportError:
        return _tile_scan(i0_list, s["groups"], s["coverage"],
                          s["sizes_flat"], s["seed_ok"],
                          s["partner_ok"], s["c"], s["mincov"],
                          s["gap"], s["tile"], s["matmul"], s["fast"])


def compute_maxcorrs(msa: np.ndarray, cfg: MaxCorrConfig,
                     tile: int = 256,
                     matmul=np.matmul, fast: bool = False,
                     threads: int = 0, native: str = "auto",
                     checkpoint_path: str | None = None) -> np.ndarray:
    """MaxCorrs for a full MSA -> float64 [C*5].

    fast=True uses the mode-gated fixed-term significance
    (hypergeom.positive_significance_fast): identical cutoff decisions,
    ~20x cheaper; fast=False is the exact golden-parity path.
    threads>1 forks workers striped over seed tiles and merges with
    elementwise max — value-identical to the serial scan.
    native="auto" routes large fast scans through the banded-bitset
    C++ kernel (compute_maxcorrs_native, value-equal within fp
    tolerance); "never" forces the numpy path, "always" forces native."""
    msa = np.asarray(msa)
    if native != "never" and (native == "always" or
                              (fast and msa.size >= 1 << 22)):
        try:
            return compute_maxcorrs_native(
                msa, cfg, fast=fast, threads=max(threads, 1),
                checkpoint_path=checkpoint_path)
        except RuntimeError:
            pass  # native lib unavailable -> numpy path
    r, c = msa.shape
    signumber = r
    mincov = cfg.mincov
    maxgroup = signumber
    groups, coverage, sizes, covcount = group_matrices(msa)
    sizes_flat = sizes.reshape(-1)

    baseno = sizes[:, 0:4].sum(axis=1)
    size_ok = (sizes_flat > mincov // 4) & (sizes_flat < maxgroup)
    seed_ok = size_ok.reshape(c, 5).copy()
    if cfg.majority_filter:
        seed_ok &= (baseno > covcount // 2)[:, None]
    partner_ok = size_ok.reshape(c, 5)
    gap = cfg.min_col_gap

    i0s = list(range(0, c, tile))
    if threads > 1 and len(i0s) > threads:
        import multiprocessing as mp
        _FORK_STATE.update(groups=groups, coverage=coverage,
                           sizes_flat=sizes_flat, seed_ok=seed_ok,
                           partner_ok=partner_ok, c=c, mincov=mincov,
                           gap=gap, tile=tile, matmul=matmul, fast=fast)
        try:
            ctx = mp.get_context("fork")
            with ctx.Pool(threads) as pool:
                parts = pool.map(_scan_seed_tiles,
                                 [i0s[w::threads]
                                  for w in range(threads)])
            return np.maximum.reduce(parts)
        finally:
            _FORK_STATE.clear()
    return _tile_scan(i0s, groups, coverage, sizes_flat, seed_ok,
                      partner_ok, c, mincov, gap, tile, matmul, fast)


def _tile_scan(i0_list, groups, coverage, sizes_flat, seed_ok,
               partner_ok, c, mincov, gap, tile, matmul,
               fast) -> np.ndarray:
    maxcorrs = np.zeros(c * 5, np.float64)
    for i0 in i0_list:
        i1 = min(c, i0 + tile)
        ti = i1 - i0
        seed_cols = seed_ok[i0:i1].any(axis=1)
        alive = seed_cols.copy()      # not yet hit the coverage break
        if not seed_cols.any():
            continue
        gi = groups[i0 * 5:i1 * 5]                  # [ti*5, R]
        ci = coverage[i0:i1]                        # [ti, R]
        for j0 in range(i0, c, tile):
            if not alive.any():
                break
            j1 = min(c, j0 + tile)
            tj = j1 - j0
            cj = coverage[j0:j1]
            # counts are small ints: f32 matmul results are exact;
            # full-tile astype copies are the single biggest cost.
            shared = matmul(ci, cj.T)                    # [ti, tj] f32
            ii = np.arange(i0, i1)[:, None]
            jj = np.arange(j0, j1)[None, :]
            valid = jj >= ii + gap
            fail = valid & (shared < mincov)
            cumfail = np.logical_or.accumulate(fail, axis=1)
            allowed = valid & alive[:, None] & ~cumfail
            alive &= ~cumfail[:, -1]
            if not allowed.any():
                continue
            gj = groups[j0 * 5:j1 * 5]
            schnitt = matmul(gi, gj.T)                   # [ti*5, tj*5]
            gr1 = matmul(gi, cj.T)                       # [ti*5, tj]
            gr2 = matmul(ci, gj.T)                       # [ti, tj*5]

            pair_ok = (allowed[:, None, :, None]
                       & seed_ok[i0:i1][:, :, None, None]
                       & partner_ok[j0:j1][None, None, :, :])
            pi, pk, pj, pkk = np.nonzero(pair_ok)
            if pi.size == 0:
                continue
            s_ = schnitt[pi * 5 + pk, pj * 5 + pkk].astype(np.int64)
            g1 = gr1[pi * 5 + pk, pj].astype(np.int64)
            g2 = gr2[pi, pj * 5 + pkk].astype(np.int64)
            cv = shared[pi, pj].astype(np.int64)
            sz1 = sizes_flat[(pi + i0) * 5 + pk]
            sz2 = sizes_flat[(pj + j0) * 5 + pkk]
            if fast:
                z = hg.positive_significance_fast(s_, g1, g2, cv, sz1,
                                                  sz2)
            else:
                z = hg.positive_significance(s_, g1, g2, cv, sz1, sz2)
            # dense-tile max reduction (ufunc.at scatter is too slow)
            zt = np.zeros((ti * 5, tj * 5), np.float32)
            zt[pi * 5 + pk, pj * 5 + pkk] = z
            np.maximum(maxcorrs[i0 * 5:i1 * 5], zt.max(axis=1),
                       out=maxcorrs[i0 * 5:i1 * 5])
            np.maximum(maxcorrs[j0 * 5:j1 * 5], zt.max(axis=0),
                       out=maxcorrs[j0 * 5:j1 * 5])
    return maxcorrs


def compute_maxcorrs_native(msa: np.ndarray, cfg: MaxCorrConfig,
                            fast: bool = True, threads: int = 4,
                            chunk: int = 4096,
                            checkpoint_path: str | None = None,
                            progress: bool = True) -> np.ndarray:
    """Banded-bitset C++ scan (native/host_ops.cpp maxcorr_scan).

    Same gate/break/value semantics as compute_maxcorrs (threaded-
    variant contract, MaxCorrelation.c:744-908): value-equal within fp
    tolerance (~1e-9; libm vs scipy lgamma). Seed columns are scanned
    in chunks; with checkpoint_path, the accumulated maxes and the
    next chunk index are written atomically after each chunk, and an
    interrupted scan resumes from the last completed chunk (the
    reference's own MaxCorrs-on-disk caching, MaxCorrelation.c:1014,
    made restartable mid-computation)."""
    import time

    from ..utils import native
    from ..utils.checkpoint import _atomic_write

    msa = np.asarray(msa)
    r, c = msa.shape
    bits = native.MaxCorrBitsets(msa)       # raises if lib missing
    maxcorrs = np.zeros(c * 5, np.float64)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            if (int(z["c"]) == c and int(z["r"]) == r
                    and bool(z["fast"]) == fast):
                maxcorrs = z["maxcorrs"].copy()
                start = int(z["next"])
    t0 = time.perf_counter()
    for i0 in range(start, c, chunk):
        i1 = min(c, i0 + chunk)
        bits.scan(maxcorrs, i0, i1, cfg.mincov, cfg.min_col_gap,
                  r, cfg.majority_filter, fast, threads)
        if checkpoint_path:
            def w(f, i1=i1):
                np.savez(f, maxcorrs=maxcorrs, next=i1, c=c, r=r,
                         fast=fast)
            _atomic_write(checkpoint_path, w)
        if progress:
            dt = time.perf_counter() - t0
            done = i1 - start
            eta = dt / done * (c - i1) if done else 0.0
            print(f"  maxcorr scan {i1}/{c} cols "
                  f"({dt:.0f}s, eta {eta:.0f}s)", flush=True)
    return maxcorrs


def compute_maxcorrs_device(msa: np.ndarray, cfg: MaxCorrConfig,
                            tile: int = 256, mesh=None) -> np.ndarray:
    """Device path: one-hot groups built on device, int8 matmuls per
    tile pair, f32 hypergeometric on device, per-group max accumulated
    on device — the whole gated scan (seed gates, >=gap pair distance,
    coverage break, per-group max) is ONE dispatch: a fori_loop over
    seed tiles whose partner sweep is a while_loop that exits at the
    coverage break on device (MaxCorrelation.c:804-810 semantics; the
    old host tile-pair loop paid a blocking alive readback per tile).

    mesh: a jax.sharding.Mesh with a 'rows' axis — seed tiles are
    striped round-robin over the devices (the reference's pthread seed
    stripes, MaxCorrelation.c:796) and the per-device accumulators
    merge with an elementwise pmax (the thread merge, :881-891).

    Semantics mirror compute_maxcorrs; Z values are f32 (~1e-3) — use
    compute_maxcorrs for golden parity."""
    import jax
    import jax.numpy as jnp

    from ..ops.hypergeom_device import (log_factorial_table,
                                        positive_significance_f32)

    msa = np.asarray(msa)
    r, c = msa.shape
    # all hypergeometric args are counts <= r: gather log-factorials
    # from a host-f64 double-float table instead of device gammaln.
    # The table MUST cover max(cov) (= r here by construction) — the
    # device gather clips out-of-range indices silently, which is only
    # safe for the negative indices of irrelevant pairs.
    lf_np_hi, lf_np_lo = log_factorial_table(r)
    assert lf_np_hi.shape[0] - 1 >= r, "log-factorial table undersized"
    lf_hi, lf_lo = jnp.asarray(lf_np_hi), jnp.asarray(lf_np_lo)
    signumber = r
    mincov = cfg.mincov
    gap = cfg.min_col_gap
    cpad = -(-c // tile) * tile
    msa_p = np.full((r, cpad), 5, np.int8)
    msa_p[:, :c] = msa

    dev = jnp.asarray(msa_p)                       # [R, Cp]
    groups = jnp.stack([(dev == s) for s in range(5)],
                       axis=1).astype(jnp.int8)    # [R, 5, Cp]
    groups = groups.transpose(2, 1, 0).reshape(cpad * 5, r)  # [Cp5, R]
    coverage = (dev < 5).astype(jnp.int8).T        # [Cp, R]
    sizes = groups.sum(axis=1, dtype=jnp.int32)    # [Cp5]
    covcount = coverage.sum(axis=1, dtype=jnp.int32)
    baseno = sizes.reshape(cpad, 5)[:, 0:4].sum(axis=1)
    size_ok = (sizes > mincov // 4) & (sizes < signumber)
    seed_ok = size_ok.reshape(cpad, 5)
    if cfg.majority_filter:
        seed_ok = seed_ok & (baseno > covcount // 2)[:, None]
    partner_ok = size_ok.reshape(cpad, 5)

    t = tile
    nt = cpad // t

    def tile_step(acc, alive, i0, j0, gi, ci, sok, szi,
                  groups, coverage, partner_ok, sizes):
        gj = jax.lax.dynamic_slice(groups, (j0 * 5, 0), (t * 5, r))
        cj = jax.lax.dynamic_slice(coverage, (j0, 0), (t, r))
        shared = jnp.dot(ci, cj.T,
                         preferred_element_type=jnp.int32)
        ii = i0 + jnp.arange(t)[:, None]
        jj = j0 + jnp.arange(t)[None, :]
        valid = (jj >= ii + gap) & (jj < c)
        fail = valid & (shared < mincov)
        cumfail = jnp.cumsum(fail.astype(jnp.int32), axis=1) > 0
        allowed = valid & alive[:, None] & ~cumfail
        alive_next = alive & ~cumfail[:, -1]

        schnitt = jnp.dot(gi, gj.T, preferred_element_type=jnp.int32)
        gr1 = jnp.dot(gi, cj.T, preferred_element_type=jnp.int32)
        gr2 = jnp.dot(ci, gj.T, preferred_element_type=jnp.int32)

        pok = jax.lax.dynamic_slice(partner_ok, (j0, 0), (t, 5))
        szj = jax.lax.dynamic_slice(sizes, (j0 * 5,), (t * 5,))

        pair_ok = (allowed[:, None, :, None]
                   & sok[:, :, None, None]
                   & pok[None, None, :, :]).reshape(t * 5, t * 5)
        g1 = jnp.repeat(gr1, 5, axis=1)            # [t5, t5]
        g2 = jnp.repeat(gr2, 5, axis=0)            # [t5, t5]
        cv = jnp.repeat(jnp.repeat(shared, 5, axis=0), 5, axis=1)
        z = positive_significance_f32(
            schnitt, g1, g2, cv, szi[:, None], szj[None, :],
            lf_hi, lf_lo)
        z = jnp.where(pair_ok, z, 0.0)

        zi = z.max(axis=1)
        zj = z.max(axis=0)
        ai = jax.lax.dynamic_slice(acc, (i0 * 5,), (t * 5,))
        acc = jax.lax.dynamic_update_slice(
            acc, jnp.maximum(ai, zi), (i0 * 5,))
        aj = jax.lax.dynamic_slice(acc, (j0 * 5,), (t * 5,))
        acc = jax.lax.dynamic_update_slice(
            acc, jnp.maximum(aj, zj), (j0 * 5,))
        return acc, alive_next

    def scan(groups, coverage, sizes, seed_ok, partner_ok, i_tiles):
        """Full gated scan of the seed tiles in i_tiles (int32 [NI];
        entries >= nt are stride padding and scan nothing)."""

        def one_seed(k, acc):
            it = jnp.minimum(i_tiles[k], nt - 1)
            i0 = it * t
            sok = jax.lax.dynamic_slice(seed_ok, (i0, 0), (t, 5))
            alive0 = sok.any(axis=1) & (i_tiles[k] < nt)
            gi = jax.lax.dynamic_slice(groups, (i0 * 5, 0), (t * 5, r))
            ci = jax.lax.dynamic_slice(coverage, (i0, 0), (t, r))
            szi = jax.lax.dynamic_slice(sizes, (i0 * 5,), (t * 5,))

            def cond(st):
                j, alive, _ = st
                return (j < nt) & alive.any()

            def body(st):
                j, alive, acc = st
                acc, alive = tile_step(acc, alive, i0, j * t, gi, ci,
                                       sok, szi, groups, coverage,
                                       partner_ok, sizes)
                return j + 1, alive, acc

            _, _, acc = jax.lax.while_loop(cond, body,
                                           (it, alive0, acc))
            return acc

        acc0 = jnp.zeros(cpad * 5, jnp.float32)
        return jax.lax.fori_loop(0, i_tiles.shape[0], one_seed, acc0)

    if mesh is None:
        acc = jax.jit(scan)(groups, coverage, sizes, seed_ok,
                            partner_ok,
                            jnp.arange(nt, dtype=jnp.int32))
    else:
        from jax.sharding import PartitionSpec as P
        n = int(mesh.devices.size)
        ni = -(-nt // n)

        def local(groups, coverage, sizes, seed_ok, partner_ok):
            dev_i = jax.lax.axis_index("rows").astype(jnp.int32)
            i_tiles = dev_i + n * jnp.arange(ni, dtype=jnp.int32)
            acc = scan(groups, coverage, sizes, seed_ok, partner_ok,
                       i_tiles)
            return jax.lax.pmax(acc, "rows")

        fn = jax.shard_map(local, mesh=mesh,
                           in_specs=(P(), P(), P(), P(), P()),
                           out_specs=P(), check_vma=False)
        acc = jax.jit(fn)(groups, coverage, sizes, seed_ok, partner_ok)
    return np.asarray(acc)[: c * 5].astype(np.float64)


def run(msa_path: str, cfg: MaxCorrConfig, out_path: str | None = None,
        **kw) -> np.ndarray:
    """CLI-equivalent: MSA file in, MaxCorrsOf_<path> out."""
    from ..utils import io as rio
    msa = rio.read_msa(msa_path)
    mc = compute_maxcorrs(msa, cfg, **kw)
    if out_path is None:
        out_path = rio.maxcorrs_path(msa_path)
    rio.write_maxcorrs(out_path, mc)
    return mc
