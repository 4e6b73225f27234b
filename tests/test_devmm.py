"""The device-routed resolver matmuls (ops/devmm) must be value-
identical to the host BLAS path — intersection counts are exact
integers either way — and the resolver's subdivision files must be
byte-identical no matter where the products ran."""
import numpy as np
import pytest

from repeatresolver_tpu.ops import devmm


def test_matmul_t_device_equals_host():
    rng = np.random.default_rng(0)
    a = (rng.random((300, 257)) < 0.3)
    b = (rng.random((120, 257)) < 0.6)
    host = devmm.matmul_t(a, b, force=False)
    dev = devmm.matmul_t(a, b, force=True)
    np.testing.assert_array_equal(host, dev)
    assert host.dtype == np.int32
    # against a plain int64 reference
    ref = a.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(host.astype(np.int64), ref)


def test_operand_device_copy_reused():
    a = devmm.Operand(np.eye(16, dtype=bool))
    b = np.ones((4, 16), bool)
    out1 = devmm.matmul_t(a, b, force=True)
    d1 = a._dev
    out2 = devmm.matmul_t(a, b, force=True)
    assert a._dev is d1                  # no re-transfer
    np.testing.assert_array_equal(out1, out2)
    ref = a.host.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(out1.astype(np.int64), ref)


def test_resolver_device_route_byte_identical(monkeypatch):
    """resolve_window with every matmul forced through the jnp route
    must emit byte-identical subdivisions to the pure-host run."""
    from repeatresolver_tpu import config as C
    from repeatresolver_tpu.models import maxcorr, resolver

    rng = np.random.default_rng(7)
    n_copies, cov, w = 4, 8, 400
    tpl = rng.integers(0, 4, w)
    copies = [tpl.copy() for _ in range(n_copies)]
    for cp in copies:
        snps = rng.choice(w, 6, replace=False)
        cp[snps] = (cp[snps] + 1 + rng.integers(0, 3, 6)) % 4
    rows = []
    for cp in copies:
        for _ in range(cov):
            r = cp.copy()
            err = rng.random(w) < 0.05
            r[err] = rng.integers(0, 4, err.sum())
            rows.append(r)
    msa = np.array(rows, np.int8)
    mc = np.asarray(maxcorr.compute_maxcorrs(
        msa, maxcorr.MaxCorrConfig(mincov=cov)))

    cfg = C.ResolverConfig(cov=cov)
    monkeypatch.setitem(devmm._state, "on", False)
    host = resolver.resolve_window(msa, mc.copy(), 0, w - 1, cfg)
    monkeypatch.setitem(devmm._state, "on", True)
    monkeypatch.setattr(devmm, "MIN_DEVICE_OPS", 0.0)
    dev = resolver.resolve_window(msa, mc.copy(), 0, w - 1, cfg)
    assert host.keys() == dev.keys()
    for k in host:
        np.testing.assert_array_equal(host[k], dev[k])
    # non-degenerate: the window actually resolved into clusters
    assert host["Kmeans"].max() >= 1
