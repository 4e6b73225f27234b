"""The CUDA staircase fill's Python side: operand shapes and padding,
the route choice, and its limits. The kernel itself has no interpret
mode; the `gpu` test below and `python chip_smoke.py` compare it with
the XLA fill on the card."""
import numpy as np
import pytest

from repeatresolver_tpu.models import realigner
from repeatresolver_tpu.ops import banded_realign as br
from repeatresolver_tpu.ops import cuda_fill as cf
from repeatresolver_tpu.ops import staircase_realign as sr


def _block(seed=0, b=4, l=200, c=300):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 6, (b, c)).astype(np.int8)
    counts = np.zeros((c, 6), np.int32)
    for s in range(6):
        counts[:, s] = (rows == s).sum(axis=0) + 2
    seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
    ways = np.sort(rng.integers(0, c, (b, l)), axis=1).astype(np.int32)
    lengths = rng.integers(l // 2, l + 1, b).astype(np.int32)
    return counts, rows, seqs, ways, lengths, c


@pytest.mark.parametrize("chunk", [16, 64])
def test_kernel_inputs_shapes_and_padding(chunk):
    counts, rows, seqs, ways, lengths, c = _block()
    b, l = seqs.shape
    w = 40
    ops = [np.asarray(x) for x in cf.kernel_inputs(
        counts, rows, seqs, ways, lengths, np.int32(c - 5), bandwidth=w,
        chunk=chunk)]
    gap, ins, ns, own, gp, c4, sq, lob, a_chunks, lens, ncols = ops
    lpad = -(-l // chunk) * chunk
    assert gap.shape == ins.shape == ns.shape == own.shape == (b, c)
    assert gp.shape == (b, c + 1) and c4.shape == (c, 4)
    assert sq.shape == lob.shape == (b, lpad)
    assert a_chunks.shape == (b, lpad // chunk)
    assert lens.shape == (b,) and ncols.tolist() == [c - 5]
    assert {x.dtype for x in (gap, ins, ns, gp, c4, lob, a_chunks,
                              lens, ncols)} == {np.dtype(np.int32)}
    assert own.dtype == sq.dtype == np.int8
    # the same cost planes as the XLA fill's
    ref = [np.asarray(x) for x in br._row_costs(counts, rows)]
    np.testing.assert_array_equal(ns, ref[0])
    np.testing.assert_array_equal(gap, ref[1])
    np.testing.assert_array_equal(ins, ref[2])
    np.testing.assert_array_equal(gp, ref[3])
    # step inputs: seqs zero-padded, band starts edge-padded, one
    # window start per chunk taken at the chunk's first position
    np.testing.assert_array_equal(sq[:, :l], seqs)
    assert not sq[:, l:].any()
    ways_p = np.concatenate(
        [ways, np.repeat(ways[:, -1:], lpad - l, axis=1)], axis=1)
    np.testing.assert_array_equal(lob, np.maximum(0, ways_p - w // 2))
    np.testing.assert_array_equal(a_chunks, lob[:, ::chunk])
    np.testing.assert_array_equal(
        a_chunks[:, :, None].repeat(chunk, 2).reshape(b, lpad)[:, :l],
        sr.staircase_anf(ways, lengths, w, chunk, c))


def test_out_shapes_match_the_xla_fill():
    counts, rows, seqs, ways, lengths, c = _block()
    w, chunk, widen = 40, 32, 3
    xla = sr.staircase_fill(counts, rows, seqs, ways, lengths,
                            np.int32(c), bandwidth=w, chunk=chunk,
                            widen=widen)
    shapes = cf.out_shapes(seqs.shape[0], seqs.shape[1],
                           w + widen * chunk, chunk)
    assert [(s.shape, s.dtype) for s in shapes] == \
        [(x.shape, x.dtype) for x in xla]


def test_route_choice_by_name_and_window():
    assert sr.fill_for("cuda") is cf.staircase_fill_cuda
    for name in ("xla", "native"):
        assert sr.fill_for(name) is sr.staircase_fill
    # the band decides whether the kernel takes every window of the
    # widen ladder; the capstone band does, one past 3072 does not
    fits = realigner.BatchedRealigner.cuda_fits
    assert fits(1000) and fits(3072) and not fits(3073)
    assert realigner.BatchedRealigner.widest_window(3072) == cf.MAX_W2


@pytest.mark.parametrize("chunk,widen", [(24, 1), (128, 40)])
def test_cuda_fill_rejects_what_the_kernel_cannot_run(chunk, widen):
    counts, rows, seqs, ways, lengths, c = _block()
    with pytest.raises(ValueError, match="CUDA fill"):
        cf.staircase_fill_cuda(counts, rows, seqs, ways, lengths,
                               np.int32(c), bandwidth=1000, chunk=chunk,
                               widen=widen)


@pytest.mark.gpu
def test_cuda_fill_matches_xla_fill(gpu):
    counts, rows, seqs, ways, lengths, c = _block(seed=3, b=8, l=700,
                                                  c=900)
    for w, chunk, widen in ((64, 32, 3), (200, 128, 12)):
        kw = dict(bandwidth=w, chunk=chunk, widen=widen)
        got = cf.staircase_fill_cuda(counts, rows, seqs, ways, lengths,
                                     np.int32(c), **kw)
        want = sr.staircase_fill(counts, rows, seqs, ways, lengths,
                                 np.int32(c), **kw)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
