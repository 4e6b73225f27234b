"""Batched glocal edit-distance DP as a row scan with prefix-min
relaxation.

This is the compute core behind ReadCutter's Occurrence
(ReadCutter.c:489-568) and InitialAligner's IntoAligner
(InitialAligner.c:282-453). The recurrence (query char x vs target
char y, target consumed for free at both ends):

    M[-1][y] = 0,  M[x][-1] = x + 1
    M[x][y]  = min(M[x-1][y-1] + (q[x] != t[y]),   # diagonal
                   M[x-1][y]   + 1,                # consume query ('d')
                   M[x][y-1]   + 1)                # consume target ('i')

The in-row dependency M[x][y-1] is resolved without a sequential y loop:
with A[y] = min(diag, up) the row satisfies
    M[x][y] = y + cummin_y( A[y] - y  with boundary (x+2) at y=-1 )
which is one associative cummin per row — O(log Lt) depth instead of
an O(Lt) serial chain.

Move codes reproduce the reference's exact tie priority
(InitialAligner.c:294-324): diagonal wins ties, then 'i' (left), then
'd' (up); codes 0=sub 3=match 1='i' 2='d'.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 29)


def _row_step(m_prev, x, q_x, target):
    """One DP row. m_prev: [B, Lt] int32 row x-1; q_x: [B] query chars."""
    mism = (q_x[:, None] != target[None, :]).astype(jnp.int32)
    # diag neighbor M[x-1][y-1]: shift right, boundary M[x-1][-1] = x.
    diag = jnp.concatenate(
        [jnp.full((m_prev.shape[0], 1), x, jnp.int32), m_prev[:, :-1]],
        axis=1) + mism
    up = m_prev + 1
    a = jnp.minimum(diag, up)
    lt = m_prev.shape[1]
    iota = jnp.arange(lt, dtype=jnp.int32)[None, :]
    # boundary M[x][-1] = x+1 participates as (x+1) - (-1) = x+2.
    shifted = jnp.concatenate(
        [jnp.full((m_prev.shape[0], 1), x + 2, jnp.int32), a - iota],
        axis=1)
    m_row = jax.lax.associative_scan(jnp.minimum, shifted, axis=1)[:, 1:] \
        + iota
    return m_row, diag, up


def _codes(m_row, diag, up, mism, x):
    """Reference tie priority: diag, then left('i',1), then up('d',2)."""
    left = jnp.concatenate(
        [jnp.full((m_row.shape[0], 1), x + 1, jnp.int32), m_row[:, :-1]],
        axis=1)
    c_left = (left + 1) < diag
    cur = jnp.where(c_left, left + 1, diag)
    c_up = up < cur
    diag_code = jnp.where(mism.astype(bool), jnp.int8(0), jnp.int8(3))
    return jnp.where(c_up, jnp.int8(2),
                     jnp.where(c_left, jnp.int8(1), diag_code))


@functools.partial(jax.jit, static_argnames=())
def last_rows(queries: jax.Array, qlens: jax.Array,
              targets: jax.Array) -> jax.Array:
    """Final DP rows M[qlen-1][:] for a batch.

    queries: [B, Lq] int (pad arbitrary), qlens: [B], targets: [B, Lt]
    (or [Lt], broadcast). Returns [B, Lt] int32. Entries at y-columns
    beyond a target's real length are garbage for the caller to mask.
    """
    queries = jnp.asarray(queries)
    targets = jnp.asarray(targets)
    if targets.ndim == 1:
        targets = jnp.broadcast_to(targets[None, :],
                                   (queries.shape[0], targets.shape[0]))
    b, lq = queries.shape
    lt = targets.shape[1]

    def step(carry, x):
        m_prev, fr = carry
        mism = (queries[:, x][:, None] != targets).astype(jnp.int32)
        diag = jnp.concatenate(
            [jnp.full((b, 1), x, jnp.int32), m_prev[:, :-1]], axis=1) + mism
        up = m_prev + 1
        a = jnp.minimum(diag, up)
        iota = jnp.arange(lt, dtype=jnp.int32)[None, :]
        shifted = jnp.concatenate(
            [jnp.full((b, 1), x + 2, jnp.int32), a - iota], axis=1)
        m_row = jax.lax.associative_scan(
            jnp.minimum, shifted, axis=1)[:, 1:] + iota
        fr = jnp.where((x == qlens - 1)[:, None], m_row, fr)
        return (m_row, fr), None

    m0 = jnp.zeros((b, lt), jnp.int32)
    fr0 = jnp.zeros((b, lt), jnp.int32)
    (_, fr), _ = jax.lax.scan(step, (m0, fr0), jnp.arange(lq))
    return fr


@functools.partial(jax.jit, static_argnames=())
def align_with_codes(queries: jax.Array, qlens: jax.Array,
                     target: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Full DP with move codes against one shared target.

    queries: [B, Lq], qlens: [B], target: [Lt].
    Returns (codes [B, Lq, Lt] int8, final_rows [B, Lt] int32).
    """
    queries = jnp.asarray(queries)
    target = jnp.asarray(target)
    b, lq = queries.shape
    lt = target.shape[0]

    def step(carry, x):
        m_prev, fr = carry
        q_x = queries[:, x]
        mism = (q_x[:, None] != target[None, :]).astype(jnp.int32)
        m_row, diag, up = _row_step(m_prev, x, q_x, target)
        codes = _codes(m_row, diag, up, mism, x)
        fr = jnp.where((x == qlens - 1)[:, None], m_row, fr)
        return (m_row, fr), codes

    m0 = jnp.zeros((b, lt), jnp.int32)
    fr0 = jnp.zeros((b, lt), jnp.int32)
    (_, fr), codes = jax.lax.scan(step, (m0, fr0), jnp.arange(lq))
    return jnp.transpose(codes, (1, 0, 2)), fr


@functools.partial(jax.jit, static_argnames=())
def align_on_device(queries: jax.Array, qlens: jax.Array,
                    target: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Full alignment with ON-DEVICE backtracking.

    Only the per-base alignments [B, Lq] int32 and final-row scores
    leave the device; the [B, Lq, Lt] move-code tensor stays in device
    memory.
    Returns (alignments, final_rows); alignments[b, i] = target column
    of query base i or -1, reference semantics like backtrack_batch.
    """
    queries = jnp.asarray(queries)
    target = jnp.asarray(target)
    b, lq = queries.shape
    lt = target.shape[0]
    codes, fr = align_with_codes(queries, qlens, target)
    # entry scan: min over columns [1, lt-1], ties -> largest column
    rev = fr[:, 1:][:, ::-1]
    entries = (lt - 1 - jnp.argmin(rev, axis=1)).astype(jnp.int32)

    bidx = jnp.arange(b)
    x0 = jnp.asarray(qlens, jnp.int32) - 1
    out0 = jnp.full((b, lq), -1, jnp.int32)

    def cond(state):
        x, y, out, it = state
        return jnp.any((x > -1) & (y > -1)) & (it < lq + lt + 4)

    def body(state):
        x, y, out, it = state
        active = (x > -1) & (y > -1)
        xs = jnp.maximum(x, 0)
        ysafe = jnp.maximum(y, 0)
        code = codes[bidx, xs, ysafe]
        is_diag = active & ((code == 0) | (code == 3))
        is_left = active & (code == 1)
        is_up = active & (code == 2)
        out = out.at[bidx, xs].set(
            jnp.where(is_diag, y, out[bidx, xs]))
        x = x - (is_diag | is_up).astype(jnp.int32)
        y = y - (is_diag | is_left).astype(jnp.int32)
        return (x, y, out, it + 1)

    _, _, out, _ = jax.lax.while_loop(
        cond, body, (x0, entries, out0, jnp.int32(0)))
    return out, fr


def entry_column(final_row: np.ndarray) -> int:
    """The reference entry scan (InitialAligner.c:336-346 /
    ReadCutter.c:398-408): minimum over columns [1, Lt-1] scanned
    descending with strict '<' — ties pick the LARGEST column; column 0
    is never examined."""
    fr = np.asarray(final_row)
    lt = fr.shape[0]
    rev = fr[1:][::-1]
    return int(lt - 1 - int(np.argmin(rev)))


def backtrack_batch(codes: np.ndarray, qlens: np.ndarray,
                    entries: np.ndarray,
                    use_native: bool = True) -> np.ndarray:
    """Backtracking for a batch (native C++ per-row walk when
    available; lockstep numpy fallback).

    codes: [B, Lq, Lt] int8 from align_with_codes (on host), qlens [B],
    entries [B] (entry columns). Returns alignments [B, Lq] int32 where
    alignments[b, i] = target column of query base i, or -1 (reference
    semantics InitialAligner.c:413-445). Rows with qlen==0 are all -1.
    """
    codes = np.asarray(codes)
    if use_native:
        from ..utils import native
        out = native.editdp_backtrack(codes, np.asarray(qlens),
                                      np.asarray(entries))
        if out is not None:
            return out
    b, lq, lt = codes.shape
    x = np.asarray(qlens, np.int64) - 1
    y = np.asarray(entries, np.int64).copy()
    out = np.full((b, lq), -1, np.int32)
    active = (x >= 0) & (y >= 0)
    while active.any():
        bi = np.nonzero(active)[0]
        code = codes[bi, x[bi], y[bi]]
        is_diag = (code == 0) | (code == 3)
        is_left = code == 1
        is_up = code == 2
        di = bi[is_diag]
        out[di, x[di]] = y[di]
        x[di] -= 1
        y[di] -= 1
        y[bi[is_left]] -= 1
        ui = bi[is_up]
        # 'd': query base placed between template bases -> stays -1.
        x[ui] -= 1
        active = (x >= 0) & (y >= 0)
    # Remaining x>-1 bases are leading 'd's: already -1.
    return out
