"""The device realigner must reproduce the serial engine exactly at
block_rows=1 and behave sanely (monotone best, convergent) at larger
blocks."""
import numpy as np
import pytest

from repeatresolver_tpu.config import RealignerConfig
from repeatresolver_tpu.models import realigner


def make_msa(seed=0, rows=12, tlen=220):
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, tlen)
    msa = np.full((rows, tlen), 5, np.int8)
    for r in range(rows):
        lo = rng.integers(0, 25)
        hi = tlen - rng.integers(0, 25)
        seg = tpl[lo:hi].copy()
        sub = rng.random(len(seg)) < 0.08
        seg[sub] = rng.integers(0, 4, sub.sum())
        gap = rng.random(len(seg)) < 0.10
        seg[gap] = 4
        msa[r, lo:hi] = seg
    return msa


def test_block1_matches_serial():
    msa = make_msa(3)
    cfg = RealignerConfig(bandwidth=96)
    log_serial: list = []
    out_serial = realigner.realign(msa.copy(), cfg,
                                   score_log=log_serial)
    log_batched: list = []
    out_batched = realigner.realign_batched(msa.copy(), cfg,
                                            score_log=log_batched,
                                            block_rows=1)
    assert log_serial == log_batched
    np.testing.assert_array_equal(out_serial, out_batched)


def test_block4_converges_and_improves():
    msa = make_msa(7, rows=16, tlen=260)
    cfg = RealignerConfig(bandwidth=96)
    log: list = []
    out = realigner.realign_batched(msa.copy(), cfg, score_log=log,
                                    block_rows=4)
    scores = [m * 1000000 + u for m, u in log]
    assert min(scores) < scores[0]          # improved
    assert out is not None
    # best tracking: returned MSA corresponds to the min score
    eng = realigner.RealignEngine(out, bandwidth=96)
    m, u = realigner.overall_score_pair(eng.counts)
    assert m * 1000000 + u == min(scores)


def test_staircase_mode_converges():
    msa = make_msa(11, rows=14, tlen=240)
    cfg = RealignerConfig(bandwidth=96)
    log: list = []
    out = realigner.realign_batched(msa.copy(), cfg, score_log=log,
                                    block_rows=4, mode="staircase")
    scores = [m * 1000000 + u for m, u in log]
    assert min(scores) < scores[0]
    # best-MSA contract holds
    eng = realigner.RealignEngine(out, bandwidth=96)
    m, u = realigner.overall_score_pair(eng.counts)
    assert m * 1000000 + u == min(scores)
    # staircase quality close to exact-band quality
    log2: list = []
    realigner.realign_batched(msa.copy(), cfg, score_log=log2,
                              block_rows=4, mode="exact")
    exact_best = min(m * 1000000 + u for m, u in log2)
    assert min(scores) <= exact_best * 1.02 + 10


def test_staircase_pallas_kernel_matches_xla_engine():
    """The device route (staircase fill + walk on the resident engine)
    reproduces the exact-band XLA engine's trajectory and result."""
    msa = make_msa(13, rows=10, tlen=200)
    cfg = RealignerConfig(bandwidth=64)
    log_x: list = []
    out_x = realigner.realign_batched(msa.copy(), cfg, score_log=log_x,
                                      block_rows=8, mode="exact",
                                      kernel="xla")
    log_p: list = []
    out_p = realigner.realign_batched(msa.copy(), cfg, score_log=log_p,
                                      block_rows=8, mode="staircase",
                                      kernel="xla")
    assert log_x == log_p
    np.testing.assert_array_equal(out_x, out_p)


def test_native_kernel_matches_serial_block1():
    msa = make_msa(17, rows=12, tlen=220)
    cfg = RealignerConfig(bandwidth=96)
    log_s: list = []
    out_s = realigner.realign(msa.copy(), cfg, score_log=log_s)
    log_n: list = []
    out_n = realigner.realign_batched(msa.copy(), cfg, score_log=log_n,
                                      block_rows=1, kernel="native")
    assert log_s == log_n
    np.testing.assert_array_equal(out_s, out_n)


def test_native_kernel_matches_xla_blocked():
    msa = make_msa(19, rows=14, tlen=240)
    cfg = RealignerConfig(bandwidth=96)
    log_x: list = []
    out_x = realigner.realign_batched(msa.copy(), cfg, score_log=log_x,
                                      block_rows=4, kernel="xla")
    log_n: list = []
    out_n = realigner.realign_batched(msa.copy(), cfg, score_log=log_n,
                                      block_rows=4, kernel="native")
    assert log_x == log_n
    np.testing.assert_array_equal(out_x, out_n)


def make_gap_dense_msa(seed=23, rows=10, tlen=280, gap_frac=0.55):
    """An MSA whose column paths drift >1 col/base (early-round gap
    density): width ~= tlen / (1 - gap_frac)."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, tlen)
    width = int(tlen / (1.0 - gap_frac)) + 8
    msa = np.full((rows, width), 5, np.int8)
    for r in range(rows):
        cols = np.sort(rng.choice(width, tlen, replace=False))
        seg = tpl.copy()
        sub = rng.random(tlen) < 0.08
        seg[sub] = rng.integers(0, 4, sub.sum())
        row = np.full(width, 4, np.int8)
        row[cols] = seg
        lo = rng.integers(0, 10)
        hi = width - rng.integers(0, 10)
        msa[r, lo:hi] = row[lo:hi]
    return msa


def test_staircase_widen_covers_gap_dense_paths():
    """Regression: with column paths drifting ~2 cols/base the fixed
    W+chunk window used to clip the reference band and sweeps made the
    score WORSE; the drift-adaptive widen
    must keep staircase quality at the exact-band level."""
    msa = make_gap_dense_msa()
    cfg = RealignerConfig(bandwidth=96)
    log_s: list = []
    realigner.realign_batched(msa.copy(), cfg, score_log=log_s,
                              block_rows=4, mode="staircase",
                              kernel="xla")
    s_scores = [m * 1000000 + u for m, u in log_s]
    assert min(s_scores) < s_scores[0]          # actually improves
    log_e: list = []
    realigner.realign_batched(msa.copy(), cfg, score_log=log_e,
                              block_rows=4, mode="exact")
    exact_best = min(m * 1000000 + u for m, u in log_e)
    assert min(s_scores) <= exact_best * 1.01 + 10


def test_staircase_overcap_drift_falls_back_exact():
    """A short fragment scattered across a wide span can drift more
    columns per chunk than any bounded widen slack covers (seen on the
    full paper-scale MSA). Blocks beyond the cap must fall back to the
    exact banded fill instead of silently truncating the band — so the
    staircase trajectory stays identical to exact mode."""
    msa = make_msa(7, rows=8, tlen=360)
    # row 0: ~24 bases spread over ~340 columns -> single-chunk drift
    # ~340 > 16 * chunk(16) = 256, beyond the widen cap
    rng = np.random.default_rng(41)
    row = np.full(360, 4, np.int8)
    cols = np.sort(rng.choice(np.arange(5, 345), 24, replace=False))
    row[cols] = rng.integers(0, 4, 24).astype(np.int8)
    msa[0] = row
    logs = {}
    for mode in ("exact", "staircase"):
        eng = realigner.BatchedRealigner(
            msa.copy(), bandwidth=96, block_rows=2, mode=mode,
            kernel="xla", chunk=16)
        eng.ent_al_gapper()
        log = [eng.overall_pair()]
        for _ in range(3):
            eng.sweep()
            log.append(eng.overall_pair())
        logs[mode] = log
    assert logs["staircase"] == logs["exact"]


def test_staircase_block1_matches_serial():
    """With the reference-band mask, the staircase window is purely a
    drift-following device: at block_rows=1 it must reproduce the
    serial reference trajectory exactly, as the exact-band device walk
    does."""
    msa = make_msa(11, rows=14, tlen=240)
    cfg = RealignerConfig(bandwidth=96, max_rounds=6)
    log_s: list = []
    out_s = realigner.realign(msa.copy(), cfg, score_log=log_s)
    for mode in ("staircase", "exact"):
        log_b: list = []
        out_b = realigner.realign_batched(
            msa.copy(), cfg, score_log=log_b, block_rows=1,
            mode=mode, kernel="xla")
        assert log_s == log_b, mode
        np.testing.assert_array_equal(out_s, out_b)


def test_pallas_row_cap_falls_back_to_xla(monkeypatch):
    """On the GPU, a band whose widest staircase window is wider than
    the CUDA kernel takes runs the XLA fill from the start: the stats
    name that fill, the CUDA fill is never entered, and the trajectory
    equals the XLA route's."""
    from repeatresolver_tpu import platform
    from repeatresolver_tpu.ops import cuda_fill

    def boom(*a, **k):
        raise AssertionError("CUDA fill called beyond its window cap")

    msa = make_msa(13, rows=10, tlen=200)
    cfg = RealignerConfig(bandwidth=64)
    log_x: list = []
    out_x = realigner.realign_batched(msa.copy(), cfg, score_log=log_x,
                                      block_rows=8, mode="staircase",
                                      kernel="xla")
    monkeypatch.setattr(platform, "name", lambda: "gpu")
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET", str(1 << 30))
    monkeypatch.setattr(cuda_fill, "MAX_W2", 4)
    monkeypatch.setattr(cuda_fill, "staircase_fill_cuda", boom)
    log_a: list = []
    stats: dict = {}
    out_a = realigner.realign_batched(msa.copy(), cfg, score_log=log_a,
                                      block_rows=8, stats=stats)
    assert stats["route"] == "DeviceResidentRealigner staircase/xla"
    assert log_x == log_a
    np.testing.assert_array_equal(out_x, out_a)


def test_pallas_row_cap_at_real_scale(monkeypatch):
    """A genuinely >= 32768-row MSA (column counts beyond int16) must
    realign a staircase block through the XLA fill + walk with the
    count invariant intact; asking for the CUDA fill at a band too wide
    for it fails when the engine is built, naming the way out."""
    from repeatresolver_tpu.ops import banded_realign as br
    from repeatresolver_tpu.ops import cuda_fill

    small = make_msa(3, rows=8, tlen=90)
    big = np.full((32800, small.shape[1]), 5, np.int8)
    big[:8] = small
    eng = realigner.BatchedRealigner(big, bandwidth=64, block_rows=8,
                                     mode="staircase", kernel="xla")
    assert eng.counts[:, 5].max() > np.iinfo(np.int16).max
    eng._realign_block(list(range(8)), br)
    # counts stayed consistent with the rewritten rows (W_Con_Checker
    # invariant)
    realigner.validate_counts(eng.msa, eng.counts)
    monkeypatch.setattr(cuda_fill, "MAX_W2", 4)
    with pytest.raises(ValueError, match="kernel='xla'"):
        realigner.BatchedRealigner(big, bandwidth=64, block_rows=8,
                                   mode="staircase", kernel="cuda")


def test_splice_matches_np_insert():
    """The memcpy-speed column/row splices must reproduce np.insert
    exactly, including multiple inserts at the same gap (tie order)."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 6, (7, 40)).astype(np.int8)
    positions = [0, 3, 3, 3, 17, 40, 40]
    cols = rng.integers(0, 6, (len(positions), 7)).astype(np.int8)
    got = realigner._splice_cols(arr, positions, cols)
    want = np.insert(arr, positions, cols.T, axis=1)
    np.testing.assert_array_equal(got, want)
    mat = rng.integers(0, 9, (40, 6)).astype(np.int32)
    rows = rng.integers(0, 9, (len(positions), 6)).astype(np.int32)
    got = realigner._splice_rows(mat, positions, rows)
    want = np.insert(mat, positions, rows, axis=0)
    np.testing.assert_array_equal(got, want)
    # empty insert list
    np.testing.assert_array_equal(
        realigner._splice_cols(arr, [], np.zeros((0, 7), np.int8)), arr)


def test_splice_cols_native_path():
    """Batches >64 route through the native one-pass row merge
    (native/host_ops.cpp splice_cols_native); must still be exactly
    np.insert, including ties and boundary positions."""
    rng = np.random.default_rng(11)
    arr = rng.integers(0, 6, (13, 250)).astype(np.int8)
    positions = np.sort(rng.integers(0, 251, 100)).astype(np.int64)
    cols = rng.integers(0, 6, (100, 13)).astype(np.int8)
    got = realigner._splice_cols(arr, positions, cols)
    want = np.insert(arr, positions, cols.T, axis=1)
    np.testing.assert_array_equal(got, want)


def test_anneal_polishes_to_serial_quality():
    """Block-Jacobi with anneal=True must finish at least as good as
    the serial reference engine: on stall the block shrinks (B -> B//4
    -> ... -> 1) from the best MSA, and the final block-1 rounds are
    exact Gauss-Seidel."""
    msa = make_msa(5, rows=16, tlen=260)
    cfg = RealignerConfig(bandwidth=96)
    log_serial: list = []
    realigner.realign(msa.copy(), cfg, score_log=log_serial)
    log_plain: list = []
    realigner.realign_batched(msa.copy(), cfg, score_log=log_plain,
                              block_rows=8, anneal=False)
    log_ann: list = []
    out = realigner.realign_batched(msa.copy(), cfg, score_log=log_ann,
                                    block_rows=8, anneal=True)
    assert min(log_ann) <= min(log_plain)
    assert min(log_ann) <= min(log_serial)
    # returned MSA is the best one
    eng = realigner.RealignEngine(out, bandwidth=96)
    assert realigner.overall_score_pair(eng.counts) == min(log_ann)


def test_backtrack_unroll_parity():
    """The generic U x U-patch trip body must emit bit-identical
    outputs for any unroll, including stall-heavy tiny unrolls."""
    from test_pallas_backtrack import unpack_codes

    from repeatresolver_tpu.ops import banded_realign as br
    from repeatresolver_tpu.ops import staircase_realign as sr

    rng = np.random.default_rng(5)
    b, tlen, c, w, t = 8, 256, 512, 64, 32
    msa = rng.integers(0, 4, (b, c)).astype(np.int8)
    counts = np.zeros((c, 6), np.int32)
    for s in range(6):
        counts[:, s] = (msa == s).sum(axis=0)
    counts[:, 0] += 10
    seqs = rng.integers(0, 4, (b, tlen)).astype(np.int8)
    ways = np.sort(rng.choice(c, (b, tlen)), axis=1).astype(np.int32)
    lengths = rng.integers(tlen // 2, tlen + 1, b).astype(np.int32)
    for i in range(b):
        ways[i, lengths[i]:] = ways[i, lengths[i] - 1]

    cx, bx, ax = sr.staircase_fill(
        counts, msa, seqs, ways, lengths, np.int32(c), bandwidth=w,
        chunk=t)

    w2 = w + t
    anf_full = sr.staircase_anf(ways, lengths, w, t, c)
    bh = w // 2
    last_way = ways[np.arange(b), np.maximum(lengths - 1, 0)]
    entry_bound = np.maximum(-1, last_way - bh).astype(np.int32)
    cpad = c + 64

    def run(u):
        return [np.asarray(o) for o in br.entry_and_backtrack(
            unpack_codes(cx, tlen), bx, ax, seqs, anf_full, entry_bound,
            lengths, np.int32(c), cpad=cpad, bandwidth=w2, unroll=u)]

    ref = run(1)
    for u in (2, 8, 48):
        got = run(u)
        for r, g, name in zip(ref, got,
                              ("rows", "best", "iy", "ib", "inn")):
            np.testing.assert_array_equal(r, g, err_msg=f"u={u} {name}")


