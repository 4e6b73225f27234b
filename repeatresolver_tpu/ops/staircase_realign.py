"""Staircase-band realignment: the device route of the realigner.

The reference band is re-centered at every sequence position
(PW_ReAligner.c:1496), which forces per-step windowed reads of the cost
arrays. This variant holds the band window CONSTANT across a chunk of T
positions and widens it to W2 = W + widen*T, so the window covers every
position's reference band as long as the row's column path drifts at
most widen*T columns within a chunk (BatchedRealigner measures the
drift and picks widen from a ladder):

  * one window gather per chunk instead of per step;
  * within a chunk the previous-row band reads are STATIC shifts;
  * the off-band jump rule is needed only at chunk boundaries.

Candidates are masked to each position's reference band and the
chunk-boundary shift carries the band-bottom diagonal predecessor, so
every in-band cell equals the exact-band value: results are bit-equal
to the exact band (ops/banded_realign) for any chunk and any covering
widen (tests/test_staircase_exact_parity.py).

The fill emits its move codes packed 16 steps per int32 word in
time-major layout [Lpad/16, B, W2] — the layout the walk reads, with no
transpose of the [B, L, W2] tensor. The walk (`entry_and_walk`) is a
reverse scan over those words. Two fills share the walk: the XLA fill
below and the CUDA kernel (ops/cuda_fill.py), which must match it bit
for bit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .banded_realign import BIG, MAX_INSERTS, _row_costs, entry_scan

WORD = 16          # move codes per packed int32 word (2 bits each)


def fill_for(kernel: str):
    """The staircase fill `kernel` names: the CUDA kernel for "cuda",
    else the XLA fill. Both return the same codes, so the choice never
    changes a result."""
    if kernel == "cuda":
        from . import cuda_fill
        return cuda_fill.staircase_fill_cuda
    return staircase_fill


def staircase_anf(ways: np.ndarray, lengths: np.ndarray, bandwidth: int,
                  chunk: int, ncols: int) -> np.ndarray:
    """Per-position band starts: constant within each chunk, taken from
    the reference band start of the chunk's first position."""
    b, l = ways.shape
    bh = bandwidth // 2
    nchunks = -(-l // chunk)
    anf = np.maximum(0, np.asarray(ways, np.int64) - bh)
    a = anf[:, ::chunk][:, :nchunks]                   # [B, NC]
    return np.repeat(a, chunk, axis=1)[:, :l].astype(np.int32)


@functools.partial(jax.jit,
                   static_argnames=("bandwidth", "chunk", "widen"))
def staircase_fill(counts, rows_old, seqs, ways, lengths, ncols, *,
                   bandwidth, chunk=256, widen=1):
    """XLA staircase fill. bandwidth is the reference W; the window is
    W2 = W + widen*chunk. chunk must be a multiple of 16.

    Returns (codes int32 [Lpad/16, B, W2], final_band int32 [B, W2],
    final_anf int32 [B]); Lpad is the length rounded up to a chunk
    multiple, and bits 2*(x % 16) of codes[x // 16, b, j] hold the move
    code (0 gap, 1 diagonal, 2 insert) of row b at position x, window
    lane j. An outer scan runs over chunks, an inner one over words, and
    each inner trip unrolls the word's 16 steps."""
    assert chunk % WORD == 0, chunk
    w = bandwidth
    t = chunk
    w2 = w + widen * t
    bh = w // 2
    b, c = rows_old.shape
    l = seqs.shape[1]
    nchunks = -(-l // t)
    lpad = nchunks * t
    if lpad != l:
        seqs = jnp.pad(seqs, ((0, 0), (0, lpad - l)))
        ways = jnp.pad(ways, ((0, 0), (0, lpad - l)), mode="edge")

    ns, gapcost, inscost, g = _row_costs(counts, rows_old)
    own = rows_old.astype(jnp.int32)
    pad = w2 + 1
    gapp = jnp.pad(gapcost.astype(jnp.int32), ((0, 0), (0, pad)))
    insp = jnp.pad(inscost.astype(jnp.int32), ((0, 0), (0, pad)))
    nsp = jnp.pad(ns.astype(jnp.int32), ((0, 0), (0, pad)))
    gp = jnp.pad(g, ((0, 0), (0, pad)), mode="edge")
    ownp = jnp.pad(own, ((0, 0), (0, pad)), constant_values=5)
    counts4 = jnp.pad(counts.astype(jnp.int32)[:, 0:4],
                      ((0, pad), (0, 0)))              # [C+pad, 4]

    bh_arr = jnp.maximum(0, ways - bh)                 # ref band starts
    a_chunks = bh_arr[:, ::t][:, :nchunks]             # [B, NC]
    arange_w2 = jnp.arange(w2, dtype=jnp.int32)
    nwc = t // WORD                                    # words per chunk
    # per-word step inputs, word-major: [NC, NWC, B, 16]
    seq_words = jnp.transpose(
        seqs.astype(jnp.int32).reshape(b, nchunks, nwc, WORD),
        (1, 2, 0, 3))
    lob_words = jnp.transpose(
        bh_arr.reshape(b, nchunks, nwc, WORD), (1, 2, 0, 3))

    def sl(arr, start):
        return jax.vmap(
            lambda r, s: jax.lax.dynamic_slice(r, (s,), (w2,)))(
            arr, start)

    def chunk_step(carry, xs):
        band, prev_a = carry                           # [B, W2], [B]
        ci, seq_c, lob_c = xs
        a = a_chunks[:, ci]                            # [B]
        ysw = a[:, None] + arange_w2[None, :]          # [B, W2]
        gap_w = sl(gapp, a)
        ins_w = sl(insp, a)
        ns_w = sl(nsp, a)
        own_w = sl(ownp, a)
        gy1_w = sl(gp, a + 1)                          # gp[y + 1]
        c4_w = jax.vmap(
            lambda s: jax.lax.dynamic_slice(counts4, (s, 0), (w2, 4)))(
            a)                                         # [B, W2, 4]
        # substitution cost per symbol with the row's own base removed
        sc_w = [ns_w - (c4_w[:, :, i] - (own_w == i)) for i in range(4)]

        # chunk-boundary band shift: d >= 0, jump rule above old top
        d = jnp.clip(a - prev_a, 0, w2 + 1)
        prev_ext = jnp.concatenate(
            [band, jnp.full((b, w2 + 2), BIG, jnp.int32)], axis=1)
        shifted = sl(prev_ext, d)
        jidx = arange_w2[None, :] + d[:, None]
        gtop = jax.vmap(lambda r, s: r[s])(gp, prev_a + w2)
        jump = band[:, w2 - 1:w2] + (gy1_w - gtop[:, None])
        # diagonal carry across the boundary: the exact band's diag
        # predecessor of the new window's lane 0 (col a) is col a-1 at
        # x0-1 = OLD window lane d-1, which the left-shift discards.
        # Without it a path hugging the band bottom at a chunk boundary
        # is lost and the staircase finds a worse rewrite than exact.
        g0 = gy1_w[:, 0:1] - gap_w[:, 0:1]               # gp[a]
        old_dm1 = jax.vmap(
            lambda r, s: jax.lax.dynamic_slice(r, (s,), (1,)))(
            prev_ext, jnp.clip(d - 1, 0, w2 + 1))
        bjump0 = band[:, w2 - 1:w2] + (g0 - gtop[:, None])
        bdiag = jnp.where(d[:, None] == 0, BIG,
                          jnp.where(d[:, None] - 1 >= w2, bjump0,
                                    old_dm1))
        band = jnp.where(jidx >= w2, jump, shifted)
        first_chunk = ci == 0
        band = jnp.where(first_chunk, 0, band)
        bdiag = jnp.where(first_chunk, BIG, bdiag)

        ok_ins = (ysw > 0) & (ysw < ncols - 1)
        validc = ysw < ncols
        big_col = jnp.full((b, 1), BIG, jnp.int32)

        def step(band, x, s, lo, lane0):
            # restrict candidates to position x's REFERENCE band: the
            # widened window only lets the band drift within a chunk —
            # exploring beyond [way-bh, way-bh+w) changes the optimum
            # (rows dodge each other into uncovered columns) and breaks
            # the reference's convergence behavior.
            inband = (ysw >= lo[:, None]) & (ysw < lo[:, None] + w)
            sv = s[:, None]
            subcost = jnp.where(
                sv == 0, sc_w[0],
                jnp.where(sv == 1, sc_w[1],
                          jnp.where(sv == 2, sc_w[2], sc_w[3])))
            first = x == 0
            diag_prev = jnp.where(
                first, 0, jnp.concatenate([lane0, band[:, :-1]], axis=1))
            up_prev = jnp.where(first, 0, band)
            diag = diag_prev + subcost
            av = jnp.minimum(diag,
                             jnp.where(ok_ins, up_prev + ins_w, BIG))
            av = jnp.where(validc & inband, av, BIG)
            m = jax.lax.associative_scan(jnp.minimum, av - gy1_w,
                                         axis=1) + gy1_w
            left = jnp.concatenate([big_col, m[:, :-1]], axis=1)
            is_last = (x == lengths - 1)[:, None]
            gap_hit = (m == left + gap_w) | (is_last & (m == left))
            code = jnp.where(gap_hit, 0, jnp.where(m == diag, 1, 2))
            active = (x < lengths)[:, None]
            return jnp.where(active, m, band), code

        def word_step(band, xs):
            wi, seq_w, lob_w = xs                      # [], [B,16] x2
            word = jnp.zeros((b, w2), jnp.int32)
            for k in range(WORD):
                x = ci * t + wi * WORD + k
                # lane 0's diag predecessor: the boundary carry on the
                # chunk's first step, BIG in-chunk (col a-1 is below
                # the window)
                lane0 = (jnp.where(wi == 0, bdiag, big_col) if k == 0
                         else big_col)
                band, code = step(band, x, seq_w[:, k], lob_w[:, k],
                                  lane0)
                word = word | (code << (2 * k))
            return band, word

        band, words = jax.lax.scan(
            word_step, band,
            (jnp.arange(nwc, dtype=jnp.int32), seq_c, lob_c))
        return (band, a), words

    band0 = jnp.zeros((b, w2), jnp.int32)
    a0 = jnp.zeros((b,), jnp.int32)
    (final_band, final_a), codes = jax.lax.scan(
        chunk_step, (band0, a0),
        (jnp.arange(nchunks, dtype=jnp.int32), seq_words, lob_words))
    return codes.reshape(nchunks * nwc, b, w2), final_band, final_a


def _walk_moves(codes, wayin, a_words, lengths):
    """The backtrack as a reverse scan over the packed words.

    Each sequence position x is consumed by exactly one move (a
    diagonal or an insertion, PW_ReAligner.c:1394-1410), and the gap
    moves between two x-moves are one run of code-0 cells at a single x
    (:1375-1384). So the walk is indexed by x, descending: per x, every
    row resolves its gap run AND its x-move in ONE masked max-reduce —
    over lanes <= the row's column with a nonzero code, the max of
    (lane << 2 | code) is where the gap run ends and which move fires.
    Lanes above the window are the forced band-jump gaps (:285-295) and
    fall out of the clamp. Rows join the walk at their own x = len-1.

    codes [NW, B, W2]; wayin [B] entry columns; a_words [NW, B] window
    start of each word's chunk. Returns moves [NW, B, 16] int32:
    y << 2 | move (1 diagonal, 2 insert) per (row, x), -1 for none."""
    w2 = codes.shape[2]
    iota = jnp.arange(w2, dtype=jnp.int32)[None, :]

    def trip(y, xs):
        wi, word, a = xs
        emits = [None] * WORD
        for xi in range(WORD - 1, -1, -1):
            x = wi * WORD + xi
            active = (x < lengths) & (y > -1)
            code = (word >> (2 * xi)) & 3
            cand = ((code != 0) & (iota <= (y - a)[:, None])
                    & active[:, None])
            pm = jnp.max(jnp.where(cand, (iota << 2) | code, -1),
                         axis=1)
            found = pm >= 0
            y_at = a + (pm >> 2)
            mv = pm & 3
            emits[xi] = jnp.where(active & found, (y_at << 2) | mv, -1)
            y = jnp.where(active,
                          jnp.where(found,
                                    jnp.where(mv == 2, y_at, y_at - 1),
                                    -1),
                          y)
        return y, jnp.stack(emits, axis=1)

    nw = codes.shape[0]
    _, moves = jax.lax.scan(
        trip, wayin, (jnp.arange(nw, dtype=jnp.int32), codes, a_words),
        reverse=True)
    return moves


def _moves_to_outputs(moves, seqs, lengths, best, *, cpad):
    """Rebuild (new_rows, best, iy, ib, inn) from the per-x move stream.
    The gap 4-fill is a dense range compare (every column in
    (y_final, y_high] is consumed exactly once), diagonal placements
    are one scatter with elementwise sequence values, and the insert
    lists are one packed scatter in the walk's discovery order
    (descending x)."""
    nw, b, _ = moves.shape
    lpad = nw * WORD
    m = jnp.transpose(moves, (1, 0, 2)).reshape(b, lpad)
    xs = jnp.arange(lpad, dtype=jnp.int32)[None, :]
    valid = (xs < lengths[:, None]) & (m >= 0)
    y_at = m >> 2
    code = m & 3
    diag = valid & (code == 1)
    ins = valid & (code == 2)
    # a valid x with no move record means the walk died there (y hit
    # -1 mid-run): every column below was consumed
    dead = jnp.any((xs < lengths[:, None]) & (m < 0), axis=1)
    # final y: y after the last executed move (y_at - 1 for diagonals,
    # unchanged for inserts); monotone along the walk, so a min
    y_after = jnp.where(valid, y_at - (code == 1), BIG)
    y_fin = jnp.where(dead, -1, jnp.min(y_after, axis=1))
    y_fin = jnp.where(lengths > 0, y_fin, -1)
    # highest written column: the first x-move's column (the trailing
    # gap run above it is at x = len-1 and writes nothing)
    m_last = jnp.take_along_axis(
        m, jnp.maximum(lengths[:, None] - 1, 0), axis=1)[:, 0]
    yh = jnp.where((lengths > 0) & (m_last >= 0), m_last >> 2, -1)

    bidx = jnp.arange(b)
    ycols = jnp.arange(cpad, dtype=jnp.int32)[None, :]
    out = jnp.where((ycols > y_fin[:, None]) & (ycols <= yh[:, None]),
                    jnp.int8(4), jnp.int8(5))
    out = out.at[bidx[:, None],
                 jnp.where(diag, y_at, cpad)].set(
        seqs.astype(jnp.int8), mode="drop")

    # insert lists in discovery (descending-x) order: the insert at
    # lane x gets slot = number of inserts at lanes > x
    o = jnp.cumsum(ins[:, ::-1].astype(jnp.int32), axis=1)[:, ::-1]
    inn = o[:, 0]
    slot = jnp.clip(o - 1, 0, MAX_INSERTS - 1)
    iyb = jnp.zeros((b, MAX_INSERTS), jnp.int32)
    iyb = iyb.at[bidx[:, None],
                 jnp.where(ins, slot, MAX_INSERTS)].set(
        (y_at << 2) | seqs.astype(jnp.int32), mode="drop")
    return out, best, iyb >> 2, (iyb & 3).astype(jnp.int8), inn


@functools.partial(jax.jit, static_argnames=("cpad", "bandwidth",
                                              "chunk"))
def entry_and_walk(codes, final_band, final_anf, seqs, anf_full,
                   entry_bound, lengths, ncols, *, cpad, bandwidth,
                   chunk):
    """Entry scan + walk over a staircase fill's packed codes; the same
    outputs as banded_realign.entry_and_backtrack on the unpacked codes
    (tests/test_pallas_backtrack.py).

    codes [Lpad/16, B, W2] from a staircase fill; bandwidth is the code
    row width W2 = band + widen*chunk; anf_full the per-position window
    starts (staircase_anf). Returns (new_rows int8 [B, cpad], best int32
    [B], ins_y int32 [B, K], ins_base int8 [B, K], ins_n int32 [B])."""
    w2 = bandwidth
    b, l = seqs.shape
    nw = codes.shape[0]
    assert codes.shape[2] == w2 and nw * WORD >= l
    wayin, best = entry_scan(final_band, final_anf, entry_bound, ncols,
                             cpad=cpad, bandwidth=w2)
    nchunks = -(-l // chunk)
    a_chunks = jnp.asarray(anf_full)[:, ::chunk][:, :nchunks]   # [B, NC]
    ci = np.minimum(np.arange(nw) * WORD // chunk, nchunks - 1)
    a_words = jnp.transpose(a_chunks[:, ci])                    # [NW, B]
    lengths = jnp.asarray(lengths, jnp.int32)
    moves = _walk_moves(codes, wayin, a_words, lengths)
    seqs = jnp.pad(jnp.asarray(seqs), ((0, 0), (0, nw * WORD - l)))
    return _moves_to_outputs(moves, seqs, lengths, best, cpad=cpad)
