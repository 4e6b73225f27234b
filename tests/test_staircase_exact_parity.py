"""Staircase == exact-band equivalence property.

The staircase window (ops/staircase_realign, its XLA and CUDA fills) is
a pure performance transform of the exact banded recurrence
(banded_realign.banded_fill, pinned to the serial oracle and the
reference C tool by the golden suite): candidates are masked to each
position's reference band [way-bh, way-bh+w), predecessors carry the
band-jump rule, and — the regression pinned here — the chunk-boundary
left-shift must carry OLD window lane d-1 as the new window's lane-0
diagonal predecessor (banded_realign reads j = iota + d - 1 every
step). Without that carry a path hugging the band bottom at a chunk
boundary is silently lost and the staircase picks a worse rewrite:
without it this property fails on 26/60 random cases and staircase
trajectories diverge from exact mode and from each other across chunk
sizes.

With the carry, the staircase fill + walk results are bit-equal to
exact for ANY (chunk, covering widen) — chunk and widen are
performance knobs only, which is what makes the CPU exact path and the
GPU staircase route interchangeable oracles of one another.
"""
import numpy as np
import pytest

from repeatresolver_tpu.ops import banded_realign as br
from repeatresolver_tpu.ops import staircase_realign as sr

W = 16


def _case(seed):
    rng = np.random.default_rng(seed)
    b, c, l = 4, 200, 64
    msa = rng.integers(0, 6, (b * 3, c)).astype(np.int8)
    counts = np.zeros((c, 6), np.int32)
    for s in range(6):
        counts[:, s] = (msa == s).sum(axis=0)
    rows_old = msa[:b]
    seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
    # drifty monotone ways: slow advance + occasional jumps, so paths
    # hug the moving band bottom across chunk boundaries
    steps = rng.choice([0, 1, 1, 2, 5], (b, l)).astype(np.int32)
    ways = np.minimum(np.cumsum(steps, axis=1), c - 1).astype(np.int32)
    lengths = rng.integers(l // 2, l + 1, b).astype(np.int32)
    for i in range(b):
        ways[i, lengths[i]:] = ways[i, lengths[i] - 1]
    return counts, rows_old, seqs, ways, lengths, c


@pytest.mark.parametrize("seed", [1, 3, 11, 26, 27, 29])
@pytest.mark.parametrize("chunk", [16, 32])
def test_staircase_matches_exact_any_chunk(seed, chunk):
    counts, rows_old, seqs, ways, lengths, c = _case(seed)
    b, l = seqs.shape
    ncols = np.int32(c)
    ce, fbe, fae = br.banded_fill(counts, rows_old, seqs, ways, lengths,
                                  ncols, bandwidth=W)
    anf_e = np.maximum(0, ways - W // 2).astype(np.int32)
    last_way = ways[np.arange(b), np.maximum(lengths - 1, 0)]
    eb = np.maximum(-1, last_way - W // 2).astype(np.int32)
    exact = br.entry_and_backtrack(ce, fbe, fae, seqs, anf_e, eb,
                                   lengths, ncols, cpad=c, bandwidth=W)

    starts = np.arange(0, l, chunk)
    ends = np.minimum(starts + chunk - 1, l - 1)
    drift = int((ways[:, ends] - ways[:, starts]).max())
    widen = -(-max(1, drift) // chunk)
    cs, fbs, fas = sr.staircase_fill(counts, rows_old, seqs, ways,
                                     lengths, ncols, bandwidth=W,
                                     chunk=chunk, widen=widen)
    anf_s = sr.staircase_anf(ways, lengths, W, chunk, c)
    stair = sr.entry_and_walk(cs, fbs, fas, seqs, anf_s, eb, lengths,
                              ncols, cpad=c, bandwidth=W + widen * chunk,
                              chunk=chunk)
    for name, a, s in zip(("rows", "best", "iy", "ib", "inn"),
                          exact, stair):
        a, s = np.asarray(a), np.asarray(s)
        if name in ("iy", "ib"):
            # insert slots only meaningful up to inn per row
            inn = np.asarray(exact[4])
            for i in range(b):
                assert np.array_equal(a[i, :inn[i]], s[i, :inn[i]]), \
                    f"{name} row {i}"
            continue
        assert np.array_equal(a, s), name
