"""Unit tests of the log-space hypergeometric tails (ops/hypergeom.py,
the GSL replacement — MaxCorrelation.c:413-419,455-469).

Two properties the resolver's batching relies on:
  * batch invariance — an element's value is independent of what else
    is in the call (the series stop is per-element), so per-seed,
    per-chunk and per-pair-block calls agree bit-for-bit;
  * agreement with a direct dumb log-sum-exp over the full pmf range.
"""
import numpy as np
import pytest
from scipy.special import gammaln

from repeatresolver_tpu.ops import hypergeom as hg


def _cases(rng, n_cases):
    N = rng.integers(8, 400, n_cases)
    K = np.array([rng.integers(1, x + 1) for x in N])
    n = np.array([rng.integers(1, x + 1) for x in N])
    kmin = np.maximum(n - (N - K), 0)
    kmax = np.minimum(K, n)
    k = np.array([rng.integers(lo, hi + 1)
                  for lo, hi in zip(kmin, kmax)])
    return k, K, n, N


def _dumb_q(k, K, n, N):
    """P[X > k] by direct summation in float128-ish log space."""
    js = np.arange(k + 1, min(K, n) + 1, dtype=np.float64)
    if js.size == 0:
        return 0.0
    lp = (gammaln(K + 1) - gammaln(js + 1) - gammaln(K - js + 1)
          + gammaln(N - K + 1) - gammaln(n - js + 1)
          - gammaln(N - K - n + js + 1)
          + gammaln(n + 1) + gammaln(N - n + 1) - gammaln(N + 1))
    m = lp.max()
    return float(np.exp(m) * np.exp(lp - m).sum())


def test_hyp_q_matches_direct_sum():
    rng = np.random.default_rng(0)
    k, K, n, N = _cases(rng, 200)
    q = hg.hyp_q(k, K, N - K, n)
    ref = np.array([_dumb_q(*args) for args in zip(k, K, n, N)])
    np.testing.assert_allclose(q, np.minimum(ref, 1.0),
                               rtol=1e-9, atol=1e-300)


def test_batch_invariance():
    """Values are bit-identical whether evaluated alone, in the full
    batch, or in a shuffled batch."""
    rng = np.random.default_rng(1)
    k, K, n, N = _cases(rng, 300)
    full = hg.hyp_q(k, K, N - K, n)
    solo = np.array([float(hg.hyp_q(k[i], K[i], N[i] - K[i], n[i]))
                     for i in range(50)])
    assert np.array_equal(full[:50], solo)
    perm = rng.permutation(len(k))
    shuf = hg.hyp_q(k[perm], K[perm], (N - K)[perm], n[perm])
    assert np.array_equal(full[perm], shuf)

    two = hg.cum_hyp_geo_log(k, K, N, n)
    two_solo = np.array([float(hg.cum_hyp_geo_log(
        k[i], K[i], N[i], n[i])) for i in range(50)])
    assert np.array_equal(two[:50], two_solo)


def test_gammaln_table_grows():
    big = np.array([3000, 60000], np.int64)
    direct = gammaln(big + 1.0)
    np.testing.assert_array_equal(hg._gln_int(big), direct)


def test_caps_and_gates():
    # capped significance -> 98 + F1 tiebreak (MaxCorrelation.c:432)
    z = hg.positive_significance(
        np.array([200]), np.array([200]), np.array([200]),
        np.array([400]), np.array([200]), np.array([200]))
    assert 98.0 < z[0] <= 99.0
    # empty groups and schnitt<1 are zeroed
    z = hg.positive_significance(
        np.array([0, 3, 3]), np.array([0, 5, 5]),
        np.array([4, 0, 4]), np.array([30, 30, 30]),
        np.array([5, 5, 5]), np.array([5, 5, 5]))
    assert z[0] == 0.0 and z[1] == 0.0 and z[2] > 0.0


def test_device_tail_immune_to_below_mode_overflow():
    """Regression: a below-mode pair's running pmf product
    grows geometrically, overflows f32 to inf, and — once the support
    bound zeroes its ratio — turns into NaN, which used to poison the
    while_loop's run.max() early exit and truncate the tail sum of
    every OTHER element in the batch.  Batch a tall below-mode pair
    with a slow-decaying relevant pair and check the relevant Z both
    matches the exact host value and is batch-invariant."""
    import jax.numpy as jnp

    from repeatresolver_tpu.ops.hypergeom_device import (
        log_factorial_table, positive_significance_f32)

    # slow-decaying relevant pair: s just above the mode at high counts
    # (ratio close to 1 -> many tail terms before the 1e-8 early exit)
    rel = dict(s=1060, k=2000, n=2000, N=3800, mode=(2001 * 2001) / 3802.0)
    assert rel["s"] > rel["mode"]
    # below-mode pair whose ratios overflow the f32 running product to
    # inf by ~j=12 and whose support bound zeroes the ratio at j=15
    # (inf * 0 = NaN in the old code, poisoning the whole batch's
    # early-exit condition)
    sub = dict(s=1, k=16, n=3500, N=3516)
    assert sub["s"] < (sub["k"] + 1) * (sub["n"] + 1) / (sub["N"] + 2)

    lf_hi, lf_lo = (jnp.asarray(a) for a in log_factorial_table(4096))

    def z_of(ss, kk, nn, NN):
        return np.asarray(positive_significance_f32(
            jnp.asarray(ss, jnp.int32), jnp.asarray(nn, jnp.int32),
            jnp.asarray(kk, jnp.int32), jnp.asarray(NN, jnp.int32),
            jnp.asarray(nn, jnp.int32), jnp.asarray(kk, jnp.int32),
            lf_hi, lf_lo))

    solo = z_of(np.array([rel["s"]]), np.array([rel["k"]]),
                np.array([rel["n"]]), np.array([rel["N"]]))
    mixed = z_of(np.array([rel["s"], sub["s"]]),
                 np.array([rel["k"], sub["k"]]),
                 np.array([rel["n"], sub["n"]]),
                 np.array([rel["N"], sub["N"]]))
    exact = hg.positive_significance(
        np.array([rel["s"]]), np.array([rel["n"]]),
        np.array([rel["k"]]), np.array([rel["N"]]),
        np.array([rel["n"]]), np.array([rel["k"]]))
    # batch invariance: the overflow pair must not perturb the relevant
    # element at all
    assert mixed[0] == solo[0]
    # below-mode pair is masked to exactly 0
    assert mixed[1] == 0.0
    # accuracy contract vs exact f64 host series (~1e-5 for table path)
    np.testing.assert_allclose(mixed[0], exact[0], atol=5e-4)


def test_fast_mode_gate_decisions_match():
    rng = np.random.default_rng(2)
    k, K, n, N = _cases(rng, 400)
    s1 = K + rng.integers(0, 3, len(k))
    s2 = n + rng.integers(0, 3, len(k))
    exact = hg.positive_significance(k, n, K, N, s1, s2)
    fast = hg.positive_significance_fast(k, n, K, N, s1, s2)
    # above any production cutoff (>= 4) the values agree exactly
    sig = exact > 4.0
    np.testing.assert_array_equal(fast[sig], exact[sig])
    # sub-mode zeros never cross a cutoff
    assert (fast[~sig] <= np.maximum(exact[~sig], 4.0)).all()
