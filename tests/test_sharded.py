"""Multi-chip sharding on the virtual 8-device CPU mesh."""
import jax
import numpy as np
import pytest

from repeatresolver_tpu.parallel import sharded


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual mesh")
def test_dryrun_8_devices():
    sharded.dryrun(8)


@pytest.mark.skipif(len(jax.devices()) < 4,
                    reason="needs >= 4 devices")
def test_sharded_realign_counts_consistent():
    """The psum'd histogram delta must equal a from-scratch recount of
    the rewritten rows."""
    mesh = sharded.make_mesh(4)
    rng = np.random.default_rng(1)
    r, c, l, w = 8, 512, 256, 128
    msa = np.full((r, c), 5, np.int8)
    for k in range(r):
        seg = rng.integers(0, 4, c - 60).astype(np.int8)
        gaps = rng.random(c - 60) < 0.1
        seg[gaps] = 4
        msa[k, 30:c - 30] = seg
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
        ways[k, len(pos):] = pos[-1]
    step = sharded.sharded_realign_step(mesh, ncols=c, bandwidth=w)
    new_rows, new_counts, best = step(counts, msa, seqs, ways, lengths)
    new_rows = np.asarray(new_rows)
    new_counts = np.asarray(new_counts)
    expect = counts.copy()
    for s in range(6):
        expect[:, s] += ((new_rows == s).sum(axis=0)
                         - (msa == s).sum(axis=0))
    np.testing.assert_array_equal(new_counts, expect)


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual mesh")
@pytest.mark.parametrize("mode", ["exact", "staircase"])
def test_mesh_realign_trajectory_matches_single_device(mode):
    """Production integration (BatchedRealigner mesh mode): realigning
    to convergence with each block's rows sharded over the 8-device
    mesh must produce the bit-identical score trajectory and final MSA
    as the single-device block-Jacobi run, and the counts invariant
    must hold (W_Con_Checker, PW_ReAligner.c)."""
    from test_batched_realigner import make_msa

    from repeatresolver_tpu.config import RealignerConfig
    from repeatresolver_tpu.models import realigner

    msa = make_msa(7, rows=20, tlen=300)
    cfg = RealignerConfig(bandwidth=96, block_rows=16)
    log1: list = []
    ref = realigner.realign_batched(msa.copy(), cfg, score_log=log1,
                                    mode=mode, kernel="xla")
    mesh = sharded.make_mesh(8)
    log2: list = []
    out = realigner.realign_batched(msa.copy(), cfg, score_log=log2,
                                    mode=mode, mesh=mesh)
    assert log1 == log2
    np.testing.assert_array_equal(ref, out)
    realigner.validate_counts(out, realigner.symbol_counts(out))
    # the run must actually have improved (non-degenerate fixture)
    assert min(log1) < log1[0]


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual mesh")
def test_mesh_realign_pallas_kernel_matches_xla():
    """The mesh staircase path (fill + walk inside each shard, packed
    time-major codes) must reproduce the single-device staircase run —
    the resident engine — bit for bit."""
    from test_batched_realigner import make_msa

    from repeatresolver_tpu.config import RealignerConfig
    from repeatresolver_tpu.models import realigner

    msa = make_msa(11, rows=18, tlen=280)
    cfg = RealignerConfig(bandwidth=96, block_rows=16)
    mesh = sharded.make_mesh(8)
    log1: list = []
    ref = realigner.realign_batched(msa.copy(), cfg, score_log=log1,
                                    mode="staircase", kernel="xla")
    log2: list = []
    out = realigner.realign_batched(msa.copy(), cfg, score_log=log2,
                                    mode="staircase", kernel="xla",
                                    mesh=mesh)
    assert log1 == log2
    np.testing.assert_array_equal(ref, out)


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual mesh")
def test_mesh_staircase_over_ladder_drift_takes_exact_band():
    """A block whose drift exceeds every widen rung must run the exact
    band on the mesh too (not a truncated staircase window), so the
    mesh staircase trajectory still equals the exact band's."""
    from test_batched_realigner import make_msa

    from repeatresolver_tpu.models import realigner

    msa = make_msa(7, rows=8, tlen=360)
    # row 0: 12 bases spread over ~340 columns -> single-chunk drift
    # 272 > 16 * chunk(16) = 256, beyond the widen ladder
    rng = np.random.default_rng(41)
    row = np.full(360, 4, np.int8)
    cols = np.sort(rng.choice(np.arange(5, 345), 12, replace=False))
    row[cols] = rng.integers(0, 4, 12).astype(np.int8)
    msa[0] = row
    logs = {}
    for mode, mesh in (("exact", None),
                       ("staircase", sharded.make_mesh(8))):
        eng = realigner.BatchedRealigner(
            msa.copy(), bandwidth=96, block_rows=2, mode=mode,
            kernel="xla", chunk=16, mesh=mesh)
        eng.ent_al_gapper()
        log = [eng.overall_pair()]
        for _ in range(3):
            eng.sweep()
            log.append(eng.overall_pair())
        logs[mode] = log
    assert logs["staircase"] == logs["exact"]


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual mesh")
def test_mesh_realign_uneven_block_padding():
    """Blocks not divisible by the mesh size are padded with masked
    duplicate rows; results must still match single-device exactly."""
    from test_batched_realigner import make_msa

    from repeatresolver_tpu.config import RealignerConfig
    from repeatresolver_tpu.models import realigner

    msa = make_msa(9, rows=13, tlen=260)      # 13 % 8 != 0
    cfg = RealignerConfig(bandwidth=96, block_rows=5)  # 5 % 8 != 0
    log1: list = []
    ref = realigner.realign_batched(msa.copy(), cfg, score_log=log1,
                                    mode="exact", kernel="xla")
    log2: list = []
    out = realigner.realign_batched(
        msa.copy(), cfg, score_log=log2, mode="exact",
        mesh=sharded.make_mesh(8))
    assert log1 == log2
    np.testing.assert_array_equal(ref, out)


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs the 8-device virtual mesh")
def test_mesh_blocks_respect_hbm_budget(monkeypatch):
    """The device-memory block splitting must also apply on the mesh
    path: with a tiny RR_DEVICE_HBM_BUDGET every mesh
    block is recursively halved, and the trajectory still matches the
    single-device run under the equivalent per-shard budget (the mesh
    bound divides the block footprint by the shard count)."""
    from test_batched_realigner import make_msa

    from repeatresolver_tpu.config import RealignerConfig
    from repeatresolver_tpu.models import realigner

    msa = make_msa(7, rows=20, tlen=300)
    cfg = RealignerConfig(bandwidth=96, block_rows=16)

    calls: list[int] = []
    orig = realigner.BatchedRealigner._realign_block_mesh

    def counting(self, rows, *a, **k):
        calls.append(len(rows))
        return orig(self, rows, *a, **k)

    monkeypatch.setattr(realigner.BatchedRealigner,
                        "_realign_block_mesh", counting)
    # budget of 1 B forces a split of every 16-row block into 8+8 on
    # both paths (the recursion stops at bs <= 8)
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET", "1")
    log1: list = []
    ref = realigner.realign_batched(msa.copy(), cfg, score_log=log1,
                                    mode="exact", kernel="xla")
    log2: list = []
    out = realigner.realign_batched(msa.copy(), cfg, score_log=log2,
                                    mode="exact",
                                    mesh=sharded.make_mesh(8))
    assert calls and max(calls) <= 8     # every mesh block was split
    assert log1 == log2
    np.testing.assert_array_equal(ref, out)


@pytest.mark.skipif(len(jax.devices()) < 4,
                    reason="needs >= 4 devices")
def test_mesh_maxcorrs_full_gated_scan():
    """The production sharded MaxCorrs (compute_maxcorrs_device with a
    mesh: seed tiles striped round-robin over devices like the
    reference pthread stripes, per-device accumulators merged with
    pmax — MaxCorrelation.c:796, 881-891) must match the single-device
    device scan exactly and the exact host scan within f32 tolerance."""
    from test_golden_maxcorr import planted_msa  # noqa: F401 (fixture)

    from repeatresolver_tpu.config import MaxCorrConfig
    from repeatresolver_tpu.models import maxcorr

    rng = np.random.default_rng(5)
    rows, cols = 60, 400
    consensus = rng.integers(0, 4, cols)
    msa = np.tile(consensus, (rows, 1)).astype(np.int8)
    group = np.arange(rows) % 2
    for cc in [50, 90, 140, 200, 260, 330]:
        msa[group == 1, cc] = (consensus[cc] + 1) % 4
    for rr in range(rows):
        lo = rng.integers(0, 25)
        hi = cols - rng.integers(0, 25)
        msa[rr, :lo] = 5
        msa[rr, hi:] = 5
    cfg = MaxCorrConfig(mincov=20)
    host = maxcorr.compute_maxcorrs(msa, cfg, native="never")
    single = maxcorr.compute_maxcorrs_device(msa, cfg, tile=64)
    # tile=64 keeps per-device programs far under the XLA:CPU 40 s
    # collective-rendezvous hard timeout on this oversubscribed box
    mesh = sharded.make_mesh(4)
    sharded_mc = maxcorr.compute_maxcorrs_device(msa, cfg, tile=64,
                                                 mesh=mesh)
    np.testing.assert_array_equal(sharded_mc, single)
    np.testing.assert_allclose(single, host, atol=1e-3)
    # the planted SNP columns must carry significance through the
    # sharded path
    cutoff = cfg.resolved_cutoff(msa.shape[1])
    assert (sharded_mc.reshape(-1, 5).max(axis=1)[[50, 90, 140, 200,
                                                   260, 330]]
            > cutoff).all()
