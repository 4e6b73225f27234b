"""Parity of the device-resident realigner with the host-orchestrated
block engine.

DeviceResidentRealigner keeps the MSA in device memory and applies
blocks, splices, and compaction on device; given the same block order
and flush points its math is the host path's math, so the per-sweep
(mille, uno) trajectory and the final MSA must be bit-equal to
BatchedRealigner(mode="staircase") — including the
fixed staircase slack (`widen`), which is drift headroom, not extra
band, and therefore result-neutral for any value covering the drift.
Runs on the CPU through the XLA fill."""
import numpy as np

from repeatresolver_tpu.config import RealignerConfig
from repeatresolver_tpu.models import realigner


def make_msa(seed, rows=16, tlen=300, d=0.06):
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 4, tlen)
    msa = np.full((rows, tlen), 5, np.int8)
    for k in range(rows):
        row = template.copy()
        muts = rng.random(tlen) < d
        row[muts] = rng.integers(0, 4, int(muts.sum()))
        gaps = rng.random(tlen) < 0.08
        row[gaps] = 4
        lo = rng.integers(0, tlen // 8)
        hi = tlen - rng.integers(0, tlen // 8)
        msa[k, lo:hi] = row[lo:hi]
    return msa


def _run_host(msa, sweeps, bs, band, chunk):
    eng = realigner.BatchedRealigner(
        msa.copy(), bandwidth=band, block_rows=bs, mode="staircase",
        chunk=chunk, kernel="xla")
    eng.ent_al_gapper()
    log = []
    for _ in range(sweeps):
        eng.sweep()
        log.append(eng.overall_pair())
    return log, eng.msa.copy()


def _run_resident(msa, sweeps, bs, band, chunk, widen=None):
    import os

    from repeatresolver_tpu.models.realigner_device import (
        DeviceResidentRealigner,
    )
    if widen is not None:
        os.environ["RR_RESIDENT_WIDEN"] = str(widen)
    try:
        eng = DeviceResidentRealigner(
            msa.copy(), bandwidth=band, block_rows=bs,
            mode="staircase", chunk=chunk, kernel="xla")
        eng.ent_al_gapper()
        log = []
        for _ in range(sweeps):
            eng.sweep()
            log.append(eng.overall_pair())
        eng._sync_host()
        return log, eng.msa.copy()
    finally:
        os.environ.pop("RR_RESIDENT_WIDEN", None)


def test_resident_matches_host_trajectory():
    msa = make_msa(3)
    band, chunk, bs, sweeps = 96, 32, 8, 4
    log_h, msa_h = _run_host(msa, sweeps, bs, band, chunk)
    log_d, msa_d = _run_resident(msa, sweeps, bs, band, chunk)
    assert log_h == log_d
    np.testing.assert_array_equal(msa_h, msa_d)


def test_resident_widen_is_result_neutral():
    msa = make_msa(7, rows=12, tlen=260)
    band, chunk, bs, sweeps = 96, 32, 4, 3
    base = None
    for widen in (4, 8, 12):
        log, out = _run_resident(msa, sweeps, bs, band, chunk,
                                 widen=widen)
        if base is None:
            base = (log, out)
        else:
            assert log == base[0], f"widen={widen}"
            np.testing.assert_array_equal(out, base[1])


def test_resident_exact_fallback_parity():
    """A row whose bases are spread so thin that its column-path drift
    exceeds any staircase slack must route its block through the exact
    banded fill (the host engine's own fallback) and still match the
    host trajectory."""
    msa = make_msa(5, rows=8, tlen=280)
    # plant a pathological sparse row: one base every 15 columns
    sparse = np.full(280, 5, np.int8)
    rng = np.random.default_rng(0)
    sparse[::15] = rng.integers(0, 4, len(sparse[::15]))
    msa[3] = sparse
    band, chunk, bs, sweeps = 96, 32, 4, 3
    log_h, msa_h = _run_host(msa, sweeps, bs, band, chunk)
    log_d, msa_d = _run_resident(msa, sweeps, bs, band, chunk,
                                 widen=4)
    assert log_h == log_d
    np.testing.assert_array_equal(msa_h, msa_d)


def test_resident_through_realign_batched():
    """realign_batched routes the staircase fills to the resident engine
    (RR_RESIDENT default); the full loop — best tracking, anneal,
    final gapper — must produce a final MSA at least as good as the
    host path's and a valid count invariant."""
    import os
    msa = make_msa(11, rows=12, tlen=260)
    cfg = RealignerConfig(bandwidth=96)
    log_r: list = []
    out_r = realigner.realign_batched(
        msa.copy(), cfg, block_rows=4, mode="staircase",
        kernel="xla", score_log=log_r)
    os.environ["RR_RESIDENT"] = "0"
    try:
        log_h: list = []
        out_h = realigner.realign_batched(
            msa.copy(), cfg, block_rows=4, mode="staircase",
            kernel="xla", score_log=log_h)
    finally:
        os.environ.pop("RR_RESIDENT", None)
    assert log_r == log_h
    np.testing.assert_array_equal(out_r, out_h)
    realigner.validate_counts(
        out_r, realigner.symbol_counts(out_r).astype(np.int64))


def _run_resident_eng(msa, sweeps, bs, band, chunk, **kw):
    from repeatresolver_tpu.models.realigner_device import (
        DeviceResidentRealigner,
    )
    eng = DeviceResidentRealigner(
        msa.copy(), bandwidth=band, block_rows=bs, mode="staircase",
        chunk=chunk, kernel="xla", **kw)
    eng.ent_al_gapper()
    log = []
    for _ in range(sweeps):
        eng.sweep()
        log.append(eng.overall_pair())
    return log, eng


def test_insert_overflow_routes_exact():
    """A row whose insert list overflows the fetch window must not
    abort the run: the sweep redoes with that block on the exact host
    fallback (the documented full-list refetch), and the trajectory
    stays equal to the host path's (exact band == staircase with
    covering slack)."""
    import os
    msa = make_msa(3)
    band, chunk, bs, sweeps = 96, 32, 8, 4
    log_h, msa_h = _run_host(msa, sweeps, bs, band, chunk)
    os.environ["RR_INS_FETCH"] = "1"
    try:
        log_d, eng = _run_resident_eng(msa, sweeps, bs, band, chunk)
    finally:
        os.environ.pop("RR_INS_FETCH", None)
    assert eng._overflow_events > 0   # the path actually triggered
    assert log_h == log_d
    eng._sync_host()
    np.testing.assert_array_equal(msa_h, eng.msa)


def test_insert_overflow_xla_degrade(monkeypatch):
    """Same overflow scenario with the native host lib unavailable:
    the exact fallback must degrade to the XLA banded fill, not
    abort."""
    import os

    from repeatresolver_tpu.utils import native as nat
    monkeypatch.setattr(nat, "realign_block",
                        lambda *a, **k: None)
    msa = make_msa(3)
    band, chunk, bs, sweeps = 96, 32, 8, 3
    log_h, msa_h = _run_host(msa, sweeps, bs, band, chunk)
    os.environ["RR_INS_FETCH"] = "1"
    try:
        log_d, eng = _run_resident_eng(msa, sweeps, bs, band, chunk)
    finally:
        os.environ.pop("RR_INS_FETCH", None)
    assert eng._overflow_events > 0
    assert log_h == log_d
    eng._sync_host()
    np.testing.assert_array_equal(msa_h, eng.msa)


def test_cap_crossing_flush_converges():
    """A sweep crossing the pending-insert cap mid-sweep flushes with
    drop_empty (a documented trajectory deviation): the run must keep
    the count invariant across every flush and converge to a score at
    least as good as the host path's best."""
    msa = make_msa(9, rows=16, tlen=300)
    band, chunk, bs = 96, 32, 8
    from repeatresolver_tpu.models.realigner_device import (
        DeviceResidentRealigner,
    )
    host = realigner.BatchedRealigner(
        msa.copy(), bandwidth=band, block_rows=bs, mode="staircase",
        chunk=chunk, kernel="xla")
    host.ent_al_gapper()
    best_h = host.overall_pair()
    for _ in range(12):
        host.sweep()
        p = host.overall_pair()
        if p >= best_h:
            break
        best_h = p
    eng = DeviceResidentRealigner(
        msa.copy(), bandwidth=band, block_rows=bs, mode="staircase",
        chunk=chunk, kernel="xla")
    eng._flush_cap = 4               # force mid-sweep flushes
    eng.ent_al_gapper()
    best_d = eng.overall_pair()
    for _ in range(12):
        eng.sweep()
        eng.validate()               # count invariant across flushes
        p = eng.overall_pair()
        if p >= best_d:
            break
        best_d = p
    assert best_d <= best_h


def test_widen_state_adopted_and_converted():
    """The learned drift ladder survives a respawn/checkpoint: same
    block size adopts it verbatim; a smaller block size inherits the
    max slack of the covering old blocks and propagates exact flags."""
    msa = make_msa(5, rows=16, tlen=300)
    band, chunk, bs = 96, 32, 8
    log, eng = _run_resident_eng(msa, 2, bs, band, chunk)
    ws = eng.widen_state()
    assert ws is not None and ws[0] == bs
    from repeatresolver_tpu.models.realigner_device import (
        DeviceResidentRealigner,
    )
    # same bs: verbatim adoption
    b = DeviceResidentRealigner(
        msa.copy(), bandwidth=band, block_rows=bs, mode="staircase",
        chunk=chunk, kernel="xla", widen_state=ws)
    b._upload()
    b._ensure_order_device()
    np.testing.assert_array_equal(b._block_widen, ws[1])
    # halved bs: each new block inherits the covering old block's max
    b2 = DeviceResidentRealigner(
        msa.copy(), bandwidth=band, block_rows=bs // 2,
        mode="staircase", chunk=chunk, kernel="xla",
        widen_state=ws)
    b2._upload()
    b2._ensure_order_device()
    r = msa.shape[0]
    per_row = np.repeat(ws[1], bs)[:r]
    expect = [per_row[i:i + bs // 2].max()
              for i in range(0, r, bs // 2)]
    np.testing.assert_array_equal(b2._block_widen, expect)
    # respawn carries the ladder (threshold lowered so the respawn
    # stays resident at this toy block size; production sub-threshold
    # respawns hand off to the host native engine instead)
    old_min = DeviceResidentRealigner.RESIDENT_MIN_BS
    DeviceResidentRealigner.RESIDENT_MIN_BS = 2
    try:
        b3 = eng.respawn(msa.copy(), bs // 2)
        b3._upload()
        b3._ensure_order_device()
        np.testing.assert_array_equal(b3._block_widen, expect)
    finally:
        DeviceResidentRealigner.RESIDENT_MIN_BS = old_min
    # sub-threshold respawn hands off to the host native engine
    b4 = eng.respawn(msa.copy(), bs // 2)
    assert type(b4) is realigner.BatchedRealigner
    assert (b4.mode, b4.kernel) == ("exact", "native")


def test_resume_keeps_learned_ladder(tmp_path):
    """Kill/resume: the checkpoint carries the learned drift ladder
    and the anneal position, and a resumed realign_batched completes
    from the stored state (widen is slack, not band, so the adopted
    ladder is result-neutral) with a valid count invariant and a score
    no worse than the checkpointed best."""
    from repeatresolver_tpu.utils import checkpoint as ck
    msa = make_msa(13, rows=16, tlen=300)
    ckp = str(tmp_path / "re.npz")
    # interrupted: stop after 2 rounds (simulated kill via max_rounds)
    cfg2 = RealignerConfig(bandwidth=96, max_rounds=2)
    realigner.realign_batched(
        msa.copy(), cfg2, block_rows=8, mode="staircase",
        kernel="xla", checkpoint_path=ckp)
    c = ck.RealignCheckpoint.load(ckp)
    assert c.widen is not None and c.widen_bs > 0
    assert c.block_rows > 0
    # the ladder must show learning (entries below the worst case)
    import os
    worst = int(os.environ.get("RR_RESIDENT_WIDEN", "12"))
    assert (np.asarray(c.widen) < worst).any()
    # resumed run completes from the stored state
    cfg = RealignerConfig(bandwidth=96)
    out_res = realigner.realign_batched(
        msa.copy(), cfg, block_rows=8, mode="staircase",
        kernel="xla", checkpoint_path=ckp, resume=True)
    realigner.validate_counts(
        out_res, realigner.symbol_counts(out_res).astype(np.int64))
    from repeatresolver_tpu.models.realigner import overall_score_pair
    final = overall_score_pair(realigner.symbol_counts(out_res))
    assert final <= (c.best_mille, c.best_uno)
