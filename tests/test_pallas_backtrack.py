"""Parity of the staircase walk with the generic backtrack.

The device realign step is a staircase fill (packed time-major codes)
+ staircase_realign.entry_and_walk; every output must be bit-identical
to the generic banded_realign.entry_and_backtrack on the same DP
(itself bit-identical to the serial reference walk —
tests/test_batched_realigner.py), which reads the same codes unpacked.
"""
import numpy as np
import pytest


def _inputs(seed, b, tlen, c, w, t, len_lo=0.5, gapdense=False,
            zero_rows=()):
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 4, (b, c)).astype(np.int8)
    counts = np.zeros((c, 6), np.int32)
    for s in range(6):
        counts[:, s] = (msa == s).sum(axis=0)
    counts[:, 0] += 10
    seqs = rng.integers(0, 4, (b, tlen)).astype(np.int8)
    if gapdense:
        # steep column paths: long gap runs and band jumps
        ways = np.sort(rng.choice(c, (b, tlen)), axis=1).astype(np.int32)
    else:
        ways = np.broadcast_to(
            np.linspace(0, c - 1, tlen).astype(np.int32),
            (b, tlen)).copy()
    lengths = rng.integers(max(1, int(tlen * len_lo)), tlen + 1,
                           b).astype(np.int32)
    for i in zero_rows:
        lengths[i] = 0 if i % 2 == 0 else 1
    for i in range(b):
        if lengths[i]:
            ways[i, lengths[i]:] = ways[i, lengths[i] - 1]
    return counts, msa, seqs, ways, lengths


def unpack_codes(packed, length):
    """[Lpad/16, B, W2] packed words -> [B, length, W2] uint8 codes."""
    p = np.asarray(packed)
    x = np.arange(length)
    codes = (p[x // 16] >> (2 * (x % 16))[:, None, None]) & 3
    return np.transpose(codes, (1, 0, 2)).astype(np.uint8)


def _both(counts, msa, seqs, ways, lengths, c, w, t):
    from repeatresolver_tpu.ops import banded_realign as br
    from repeatresolver_tpu.ops import staircase_realign as sr

    b, l = seqs.shape
    ck, bk, ak = sr.staircase_fill(
        counts, msa, seqs, ways, lengths, np.int32(c), bandwidth=w,
        chunk=t)
    w2 = w + t
    anf_full = sr.staircase_anf(ways, lengths, w, t, c)
    bh = w // 2
    last_way = ways[np.arange(b), np.maximum(lengths - 1, 0)]
    entry_bound = np.maximum(-1, last_way - bh).astype(np.int32)
    cpad = c + 64
    ref = [np.asarray(o) for o in br.entry_and_backtrack(
        unpack_codes(ck, l), bk, ak, seqs, anf_full, entry_bound,
        lengths, np.int32(c), cpad=cpad, bandwidth=w2)]
    got = [np.asarray(o) for o in sr.entry_and_walk(
        ck, bk, ak, seqs, anf_full, entry_bound, lengths, np.int32(c),
        cpad=cpad, bandwidth=w2, chunk=t)]
    return ref, got


@pytest.mark.parametrize("seed,gapdense,len_lo", [
    (5, False, 0.5), (7, True, 0.5), (11, True, 0.05),
])
def test_pallas_backtrack_parity(seed, gapdense, len_lo):
    b, tlen, c, w, t = 8, 256, 512, 64, 32
    args = _inputs(seed, b, tlen, c, w, t, len_lo=len_lo,
                   gapdense=gapdense)
    ref, got = _both(*args, c, w, t)
    for r, g, name in zip(ref, got, ("rows", "best", "iy", "ib",
                                     "inn")):
        np.testing.assert_array_equal(r, g, err_msg=name)


def test_pallas_backtrack_degenerate_rows():
    """Zero- and one-length rows must come back matching the oracle
    (untouched all-5 rows for length 0)."""
    b, tlen, c, w, t = 8, 64, 256, 64, 32
    args = _inputs(3, b, tlen, c, w, t, zero_rows=(2, 5))
    assert args[4][2] == 0 and args[4][5] == 1
    ref, got = _both(*args, c, w, t)
    for r, g, name in zip(ref, got, ("rows", "best", "iy", "ib",
                                     "inn")):
        np.testing.assert_array_equal(r, g, err_msg=name)
