"""Batched banded realignment DP — the device path of the realigner.

Implements the PW_ReAligner recurrence (PW_ReAligner.c:1493-1513) for a
BLOCK of rows at once, each against the shared column histogram with its
own contribution removed (block-Jacobi; block size 1 reproduces the
reference Gauss-Seidel trajectory exactly — tested).

Per scan step x (sequential over sequence positions), all rows process
their bandwidth-W window in parallel:

    A[y]  = min( M[x-1,y-1] + Score(y, base_x),
                 M[x-1,y]   + max(Score(y,5), Score(y-1,5)) )   0<y<C-1
    M[x,y] = min_{j<=y} A[j] + sum_{t=j+1..y} Score(t,4)
           = Gy[y] + cummin( A - Gy )                (associative scan)

Off-band-above reads of the previous row pay the per-column gap cost
(the reference's MatrixOut jump rule, :285-295) via the gap-cost prefix
sums G. Move codes carry the backtracker's priority (gap > diagonal >
insert, :1375-1410); the backtrack runs on device — here as a lockstep
while_loop over unpacked codes (the exact band), for the staircase
band as a scan over packed codes (ops/staircase_realign.py) — so only
the rewritten rows and insert lists leave the device.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 30)
MAX_INSERTS = 2048


def _row_costs(counts, rows_old):
    """Per-row cost arrays with own contribution removed.
    Returns ns, gapcost, inscost [B, C] and gap prefix G [B, C+1]."""
    counts = counts.astype(jnp.int32)
    own = rows_old.astype(jnp.int32)
    ns_all = counts[:, 0:5].sum(axis=1)
    ns = ns_all[None, :] - (own < 5)
    gapcost = ns - (counts[None, :, 4] - (own == 4))
    inscost = jnp.maximum(ns, jnp.concatenate(
        [ns[:, :1], ns[:, :-1]], axis=1))
    b = rows_old.shape[0]
    g = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32),
         jnp.cumsum(gapcost, axis=1, dtype=jnp.int32)], axis=1)
    return ns, gapcost, inscost, g


@functools.partial(jax.jit, static_argnames=("bandwidth", "chunk"))
def banded_fill(counts, rows_old, seqs, ways, lengths, ncols, *,
                bandwidth, chunk=256):
    """DP fill for a block.

    counts: int32 [Cp, 6]; rows_old: int8 [B, Cp]; seqs: int8 [B, L];
    ways: int32 [B, L]; lengths: int32 [B]; ncols: real column count
    (arrays may be padded beyond it — padding must be symbol 5 / zero
    counts).
    Returns (codes uint8 [B, L, W], final_band int32 [B, W],
             final_anf int32 [B]).

    Two-level structure for memory efficiency: an outer scan over chunks
    of `chunk` sequence positions gathers all banded cost windows for
    the chunk in one pass ([B, T, W] tensors); the inner scan over the
    chunk's positions is then gather-free — pure elementwise work
    plus one associative prefix-min per position.
    """
    w = bandwidth
    bh = w // 2
    b, c = rows_old.shape
    l = seqs.shape[1]
    t = chunk
    nchunks = -(-l // t)
    lpad = nchunks * t
    if lpad != l:
        seqs = jnp.pad(seqs, ((0, 0), (0, lpad - l)))
        ways = jnp.pad(ways, ((0, 0), (0, lpad - l)), mode="edge")

    ns, gapcost, inscost, g = _row_costs(counts, rows_old)
    own = rows_old.astype(jnp.int32)

    pad = w + 1
    gapp = jnp.pad(gapcost.astype(jnp.int32), ((0, 0), (0, pad)))
    insp = jnp.pad(inscost.astype(jnp.int32), ((0, 0), (0, pad)))
    nsp = jnp.pad(ns.astype(jnp.int32), ((0, 0), (0, pad)))
    gp = jnp.pad(g, ((0, 0), (0, pad)), mode="edge")     # [B, C+1+pad]
    ownp = jnp.pad(own, ((0, 0), (0, pad)), constant_values=5)
    # counts for symbols 0..3 flattened for single-gather sym lookup
    counts4_flat = jnp.pad(counts.astype(jnp.int32)[:, 0:4],
                           ((0, pad), (0, 0))).reshape(-1)  # [(C+pad)*4]

    anf_all = jnp.maximum(0, ways - bh)                  # [B, Lp]
    arange_w = jnp.arange(w, dtype=jnp.int32)
    arange_t = jnp.arange(t, dtype=jnp.int32)

    def chunk_step(carry, ci):
        prev_band, prev_anf = carry
        x0 = ci * t
        xs = x0 + arange_t                               # [T]
        anf_c = jax.lax.dynamic_slice_in_dim(anf_all, x0, t, axis=1)
        seq_c = jax.lax.dynamic_slice_in_dim(seqs, x0, t, axis=1)
        ys = anf_c[:, :, None] + arange_w[None, None, :]  # [B, T, W]

        def gat(arr):                                    # [B, Cx] -> [B,T,W]
            return jax.vmap(jnp.take)(arr, ys)

        gap_w = gat(gapp)
        ins_w = gat(insp)
        ns_w = gat(nsp)
        own_w = gat(ownp)
        gy1_w = jax.vmap(jnp.take)(gp, ys + 1)           # gp[ys+1]
        gp_anf = jax.vmap(jnp.take)(gp, anf_c)           # gp[anf] [B,T]
        # counts[ys, s] via flattened single gather
        cnt_w = jax.vmap(jnp.take)(
            jnp.broadcast_to(counts4_flat,
                             (b, counts4_flat.shape[0])),
            ys * 4 + seq_c.astype(jnp.int32)[:, :, None])
        subcost = ns_w - (cnt_w -
                          (own_w == seq_c[:, :, None]).astype(jnp.int32))
        # gp[ys] = shift of gp[ys+1] with boundary gp[anf]
        gy0_w = jnp.concatenate(
            [gp_anf[:, :, None], gy1_w[:, :, :-1]], axis=2)
        # gtop for jump reads: gp[anf(x-1) + W]; within the chunk
        # anf(x-1) is the previous slice; for the first step use carry.
        anf_prev_c = jnp.concatenate(
            [prev_anf[:, None], anf_c[:, :-1]], axis=1)  # [B, T]
        gtop_c = jax.vmap(jnp.take)(gp, anf_prev_c + w)  # [B, T]

        def step(carry, inputs):
            prev_band, prev_anf = carry
            (x, anf, seq_x, gap_x, ins_x, sub_x, gy1_x, gy0_x,
             gtop_x) = inputs
            d = anf - prev_anf                           # [B]
            # Band reads of the previous row are per-row SHIFTS by d:
            # one padded dynamic slice per row replaces a W-wide gather.
            dc = jnp.clip(d, 0, w + 1)
            prev_ext = jnp.concatenate(
                [jnp.full((b, 1), BIG, jnp.int32), prev_band,
                 jnp.full((b, w + 2), BIG, jnp.int32)], axis=1)
            sl = jax.vmap(
                lambda row, s: jax.lax.dynamic_slice(row, (s,),
                                                     (w + 1,)))(
                prev_ext, dc)
            diag_base = sl[:, :w]                        # j = iota+d-1
            up_base = sl[:, 1:w + 1]                     # j = iota+d
            j0 = arange_w[None, :] + d[:, None]
            jm = j0 - 1

            def prev_read(j, base, gy):
                jump = prev_band[:, w - 1:w] + (gy - gtop_x[:, None])
                return jnp.where(j >= w, jump,
                                 jnp.where(j >= 0, base, BIG))

            first = x == 0
            diag_prev = jnp.where(first, 0, prev_read(jm, diag_base,
                                                      gy0_x))
            up_prev = jnp.where(first, 0, prev_read(j0, up_base,
                                                    gy1_x))

            ysx = anf[:, None] + arange_w[None, :]
            diag = diag_prev + sub_x
            ok_ins = (ysx > 0) & (ysx < ncols - 1)
            a = jnp.minimum(diag,
                            jnp.where(ok_ins, up_prev + ins_x, BIG))
            a = jnp.where(ysx < ncols, a, BIG)
            m = jax.lax.associative_scan(jnp.minimum, a - gy1_x,
                                         axis=1) + gy1_x

            left = jnp.concatenate(
                [jnp.full((b, 1), BIG, jnp.int32), m[:, :-1]], axis=1)
            # Backtracker priority (PW_ReAligner.c:1375-1410): gap,
            # then the x==L-1 flat-space arm (M == left), then
            # diagonal, then insert.
            is_last = (x == lengths - 1)[:, None]
            gap_hit = (m == left + gap_x) | (is_last & (m == left))
            codes = jnp.where(gap_hit, jnp.uint8(0),
                              jnp.where(m == diag, jnp.uint8(1),
                                        jnp.uint8(2)))

            active = x < lengths
            new_band = jnp.where(active[:, None], m, prev_band)
            new_anf = jnp.where(active, anf, prev_anf)
            return (new_band, new_anf), codes

        inputs = (xs,
                  jnp.moveaxis(anf_c, 1, 0),
                  jnp.moveaxis(seq_c, 1, 0),
                  jnp.moveaxis(gap_w, 1, 0),
                  jnp.moveaxis(ins_w, 1, 0),
                  jnp.moveaxis(subcost, 1, 0),
                  jnp.moveaxis(gy1_w, 1, 0),
                  jnp.moveaxis(gy0_w, 1, 0),
                  jnp.moveaxis(gtop_c, 1, 0))
        (band, anf_out), codes_c = jax.lax.scan(
            step, (prev_band, prev_anf), inputs, unroll=2)
        return (band, anf_out), codes_c

    band0 = jnp.zeros((b, w), jnp.int32)
    anf0 = jnp.zeros((b,), jnp.int32)
    (final_band, final_anf), codes = jax.lax.scan(
        chunk_step, (band0, anf0), jnp.arange(nchunks, dtype=jnp.int32))
    codes = codes.reshape(lpad, b, w)[:l]
    return (jnp.transpose(codes, (1, 0, 2)), final_band, final_anf)


def entry_scan(final_band, final_anf, entry_bound, ncols, *, cpad,
               bandwidth):
    """Entry-column scan over M[L-1, y] for y in (bound, ncols-1]
    (PW_ReAligner.c:1353-1360): returns (wayin, best) per row, ties
    resolved to the largest y, best initialized at y = C-1 regardless
    of the bound (reference semantics)."""
    w = bandwidth
    b = final_band.shape[0]
    ycols = jnp.arange(cpad, dtype=jnp.int32)[None, :]
    j = ycols - final_anf[:, None]
    # vals[y] = band[y - anf]: place the band at lanes [anf, anf+w) by
    # a per-row binary-decomposed right-shift (pure vector selects,
    # no gather)
    vals = jnp.concatenate(
        [final_band.astype(jnp.int32),
         jnp.full((b, max(cpad - w, 0)), BIG, jnp.int32)],
        axis=1)[:, :cpad]
    k = 1
    while k < cpad:
        sh = jnp.concatenate(
            [jnp.full((b, k), BIG, jnp.int32), vals[:, :-k]], axis=1)
        vals = jnp.where((final_anf[:, None] & k) != 0, sh, vals)
        k *= 2
    flat = final_band[:, w - 1:w]
    vals = jnp.where(j >= w, flat, vals)
    vals = jnp.where(ycols < ncols, vals, BIG)
    scan_ok = (ycols > entry_bound[:, None]) & (ycols < ncols)
    scan_vals = jnp.where(scan_ok, vals, BIG)
    # the reference initializes best at y = C-1 regardless of bound
    scan_vals = jnp.where(ycols == ncols - 1, vals, scan_vals)
    rev = scan_vals[:, ::-1]                 # ties -> largest y
    wayin = (cpad - 1 - jnp.argmin(rev, axis=1)).astype(jnp.int32)
    best = jnp.take_along_axis(scan_vals, wayin[:, None], axis=1)[:, 0]
    return wayin, best


@functools.partial(jax.jit, static_argnames=("bandwidth", "cpad",
                                              "unroll"))
def entry_and_backtrack(codes, final_band, final_anf, seqs, anf_full,
                        entry_bound, lengths, ncols, *, cpad,
                        bandwidth, unroll=None):
    """Entry-column scan + lockstep backtracking on device.

    This is the walk over UNPACKED move codes [B, L, W] — the exact
    band's. Staircase fills emit packed codes, which
    staircase_realign.entry_and_walk reads instead.

    anf_full: int32 [B, L] band start per sequence position (reference
    mode: max(0, way-bh); staircase mode: the per-chunk window starts).
    entry_bound: int32 [B] lowest-exclusive column of the entry scan
    (reference: max(-1, way[len-1]-bh)). ncols is the real (dynamic)
    column count; cpad the static padded capacity. bandwidth is the
    width of the code rows (W, or W+widen*chunk for staircase).
    unroll: moves resolved per while_loop trip. Every move consumes at
    least one of x or y, so the positions the next U moves can visit
    all lie in the U x U patch [x-U+1, x] x [y-U+1, y]; the patch's
    codes/anf/seq values are fetched in ONE gather each per trip, the
    U moves resolve in registers (one-hot selects over the patch), and
    the row/insert writes land as ONE batched drop-masked scatter each.
    Bit-equal to the single-move loop for any U (tested); U=1 is the
    plain loop. 8 is the measured sweet spot (patches are U x U lanes,
    quadratic gather volume).
    Returns (new_rows int8 [B, cpad] with 4/base placements (5
    default), best int32 [B], ins_y int32 [B, K], ins_base int8 [B, K],
    ins_n int32 [B])."""
    w = bandwidth
    b = seqs.shape[0]
    l = seqs.shape[1]

    wayin, best = entry_scan(final_band, final_anf, entry_bound,
                             ncols, cpad=cpad, bandwidth=w)

    seqs8 = seqs.astype(jnp.int8)
    bidx = jnp.arange(b)
    u = int(unroll) if unroll is not None else 8
    au = jnp.arange(u, dtype=jnp.int32)

    # patch code reads: [B, U(x), U(y)] worth of 2-bit codes in one
    # gather from a per-row flat view
    _, lc, wc = codes.shape
    codes_bflat = codes.reshape(b, lc * wc)

    def read_patch(xs_p, off_p):
        idx = xs_p[:, :, None] * wc + off_p
        return jnp.take_along_axis(
            codes_bflat, idx.reshape(b, -1),
            axis=1).reshape(b, u, u).astype(jnp.int32)

    oob_col = jnp.int32(cpad)            # drop-mode scatter sink
    oob_slot = jnp.int32(MAX_INSERTS)

    def cond(state):
        x, y, out, iy, ib, inn, it = state
        return jnp.any((x > -1) & (y > -1)) & (it < cpad + l + w + 8)

    def emit(x, y, inn, active, above, code, sx, is_last,
             w_cols, w_syms, i_slots, i_ys, i_bs):
        """One move's decision + write staging."""
        gap_move = active & (above | (code == 0))
        diag_move = active & ~above & (code == 1)
        ins_move = active & ~above & (code == 2)

        write_gap = gap_move & ~is_last
        do_write = write_gap | diag_move
        w_cols.append(jnp.where(do_write, y, oob_col))
        w_syms.append(jnp.where(diag_move, sx, jnp.int8(4)))
        slot = jnp.clip(inn, 0, MAX_INSERTS - 1)
        i_slots.append(jnp.where(ins_move, slot, oob_slot))
        i_ys.append(y)
        i_bs.append(sx)
        inn = inn + ins_move.astype(jnp.int32)
        y = y - (gap_move | diag_move).astype(jnp.int32)
        x = x - (diag_move | ins_move).astype(jnp.int32)
        return x, y, inn

    def flush(out, iy, ib, w_cols, w_syms, i_slots, i_ys, i_bs):
        # one batched drop-masked scatter each: masked lanes carry an
        # out-of-bounds index and are dropped; written columns/slots
        # within a trip are distinct (each consumed y / slot is unique;
        # stalled sub-steps stage the oob sink)
        out = out.at[bidx[:, None], jnp.stack(w_cols, axis=1)].set(
            jnp.stack(w_syms, axis=1), mode="drop")
        slots = jnp.stack(i_slots, axis=1)
        iy = iy.at[bidx[:, None], slots].set(
            jnp.stack(i_ys, axis=1), mode="drop")
        ib = ib.at[bidx[:, None], slots].set(
            jnp.stack(i_bs, axis=1), mode="drop")
        return out, iy, ib

    def body(state):
        x0, y0, out, iy, ib, inn0, it = state
        xs_base = jnp.maximum(x0, 0)
        # patch tensors: everything the next U moves can touch
        xs_p = jnp.maximum(xs_base[:, None] - au[None, :], 0)  # [B,U]
        anf_p = jnp.take_along_axis(anf_full, xs_p, axis=1)    # [B,U]
        seq_p = jnp.take_along_axis(seqs8, xs_p, axis=1)       # [B,U]
        last_p = xs_p == (lengths - 1)[:, None]                # [B,U]
        ys_p = y0[:, None] - au[None, :]                       # [B,U]
        off_p = jnp.clip(ys_p[:, None, :] - anf_p[:, :, None],
                         0, w - 1)                             # [B,U,U]
        code_p = read_patch(xs_p, off_p)                       # [B,U,U]
        code_pf = code_p.reshape(b, u * u)

        x, y, inn = x0, y0, inn0
        w_cols, w_syms, i_slots, i_ys, i_bs = [], [], [], [], []
        for _ in range(u):
            active = (x > -1) & (y > -1)
            di = xs_base - jnp.maximum(x, 0)      # [B] in [0, U)
            dj = y0 - y
            sel = (au[None, :] == di[:, None])
            anf = jnp.where(sel, anf_p, 0).sum(axis=1)
            sx = jnp.where(sel, seq_p.astype(jnp.int32),
                           0).sum(axis=1).astype(jnp.int8)
            is_last = jnp.where(sel, last_p, False).any(axis=1)
            selc = (jnp.arange(u * u, dtype=jnp.int32)[None, :]
                    == (di * u + dj)[:, None])
            code = jnp.where(selc, code_pf, 0).sum(axis=1)
            above = y > anf + w - 1
            x, y, inn = emit(x, y, inn, active, above, code, sx,
                             is_last, w_cols, w_syms, i_slots, i_ys,
                             i_bs)

        out, iy, ib = flush(out, iy, ib, w_cols, w_syms, i_slots,
                            i_ys, i_bs)
        return (x, y, out, iy, ib, inn, it + u)

    out0 = jnp.full((b, cpad), 5, jnp.int8)
    iy0 = jnp.zeros((b, MAX_INSERTS), jnp.int32)
    ib0 = jnp.zeros((b, MAX_INSERTS), jnp.int8)
    inn0 = jnp.zeros((b,), jnp.int32)
    state = (lengths - 1, wayin, out0, iy0, ib0, inn0, jnp.int32(0))
    x, y, out, iy, ib, inn, _ = jax.lax.while_loop(cond, body, state)
    return out, best, iy, ib, inn
