"""On-device (f32) hypergeometric upper-tail significance.

The exact float64 series (ops/hypergeom.py) is the golden-parity path;
this is the device path for MaxCorrs at scale, where ~1e8-1e9
pair evaluations per MSA make host evaluation impossible.

Every gammaln argument in the reference significance
(MaxCorrelation.c:413-434) is a small integer count (<= MSA rows), so
instead of evaluating the f32 transcendental on device — whose ULP
error at lgamma(4000) ~ 3e4 is ~1e-2 per term and was measured to
corrupt Z by ~0.25 at 4096 rows — the log-factorial values are
precomputed on host in float64, stored as a double-float (hi, lo) f32
pair, gathered on device, and combined with compensated (TwoSum)
accumulation. Absolute error of the 9-term log-binomial sum is ~1e-6;
gathers are also cheaper than on-device lgamma evaluations.

Accuracy contract with the table: Z to ~1e-5 for significant pairs
(the remaining error is the f32 geometric-decay series, fixed K
terms); without a table (fallback gammaln path) ~1e-3 at small row
counts only. Pairs at or below the distribution mode return exactly 0
— those have true Z < ~0.5, far below the MaxCorrelation cutoff
-log10(1/(5*siglength)) >= 4, so zeroing them cannot change which
correlations matter (MaxCorrelation.c:998).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

LOG10E = 0.4342944819032518


def log_factorial_table(nmax: int):
    """Host-precomputed F[i] = lgamma(i+1) for i in 0..nmax as a
    double-float pair (hi, lo) of f32 numpy arrays."""
    v = np.array([math.lgamma(i + 1.0) for i in range(nmax + 1)],
                 np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _log_binom(n, k):
    return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)


def _logp0_table(lf_hi, lf_lo, s, k, n, nn):
    """log pmf at s for HG(N=nn, K=k, n=n) via table gathers:
    sum of 9 signed F[.] terms in compensated double-float."""
    # Indices are clipped into [0, nmax]: negative indices occur only
    # for irrelevant (masked) pairs and clip harmlessly to 0; indices
    # ABOVE nmax would silently corrupt Z — callers must size the table
    # with nmax >= max(cov) (compute_maxcorrs_device asserts this on
    # host before tracing).
    plus = (k, nn - k, n, nn - n)
    minus = (s, k - s, n - s, nn - k - n + s, nn)
    acc_hi = jnp.zeros(s.shape, jnp.float32)
    acc_lo = jnp.zeros(s.shape, jnp.float32)
    nmax = lf_hi.shape[0] - 1
    for idx_arr, sign in [(plus, 1.0), (minus, -1.0)]:
        for idx in idx_arr:
            ii = jnp.clip(idx, 0, nmax)
            acc_hi, e = _two_sum(acc_hi, sign * jnp.take(lf_hi, ii))
            acc_lo = acc_lo + e + sign * jnp.take(lf_lo, ii)
    return acc_hi + acc_lo


@functools.partial(jax.jit, static_argnames=("terms",))
def positive_significance_f32(schnitt, gr1, gr2, cov, size1, size2,
                              lf_hi=None, lf_lo=None,
                              terms: int = 128):
    """Vectorized reference PositiveSignificance (MaxCorrelation.c:
    421-434) in f32 on device, incl. the 98 -> 98+F1 cap.

    X ~ HG(N=cov, K=gr2 successes, n=gr1 draws);
    Z = -log10 P[X >= schnitt]. schnitt/gr1/gr2/cov are broadcastable
    integer count arrays. lf_hi/lf_lo: log_factorial_table(nmax) with
    nmax >= max(cov) — the accurate production path; omitted, falls
    back to on-device gammaln (small row counts only, see module doc).
    """
    si = jnp.asarray(schnitt, jnp.int32)
    ki = jnp.asarray(gr2, jnp.int32)
    ni = jnp.asarray(gr1, jnp.int32)
    nni = jnp.asarray(cov, jnp.int32)
    s = si.astype(jnp.float32)
    k = ki.astype(jnp.float32)
    n = ni.astype(jnp.float32)
    nn = nni.astype(jnp.float32)
    mode = (n + 1.0) * (k + 1.0) / (nn + 2.0)
    relevant = (s > mode) & (s >= 1) & (n > 0) & (k > 0)

    if lf_hi is not None:
        logp0 = _logp0_table(lf_hi, lf_lo, si, ki, ni, nni)
    else:
        logp0 = (_log_binom(k, s) + _log_binom(nn - k, n - s)
                 - _log_binom(nn, n))
    # pmf ratio r_j = p(s+j+1)/p(s+j); tail = 1 + sum_j prod_{i<=j} r_i.
    # Running product with element-shaped carries: a [..., terms]
    # materialization (cumsum/cumprod lanes) costs terms x the pair
    # grid in HBM — at tile 256 that was ~100 GB of intermediate
    # traffic per tile pair sweep. r_j = 0 is absorbing (matches the
    # reference's support bound), and the direct product is more
    # accurate than exp(cumsum(log)).
    shp = jnp.broadcast_shapes(s.shape, k.shape, n.shape, nn.shape)
    sb = jnp.broadcast_to(s, shp)
    kb = jnp.broadcast_to(k, shp)
    nb = jnp.broadcast_to(n, shp)
    nnb = jnp.broadcast_to(nn, shp)

    def cond(st):
        jj, run, _ = st
        # tail >= 1, so run below 1e-8 bounds the log(tail) error at
        # ~1e-8 x remaining-terms; typical decay finishes in 10-20 j.
        return (jj < terms) & (run.max() > 1e-8)

    def body(st):
        jj, run, tail = st
        sjv = sb + jj.astype(jnp.float32)
        num = (kb - sjv) * (nb - sjv)
        den = (sjv + 1.0) * (nnb - kb - nb + sjv + 1.0)
        ratio = jnp.where((num > 0) & (den > 0),
                          num / jnp.maximum(den, 1.0), 0.0)
        run = run * ratio
        return jj + 1, run, tail + run

    # Start run at 0 for non-relevant pairs: below the mode the pmf
    # ratio exceeds 1, so their running product grows geometrically,
    # overflows f32 to inf within ~10 iterations at tall-MSA counts,
    # and once the support bound zeroes the ratio inf*0 = NaN — which
    # poisons run.max() in cond (NaN > eps is False) and truncates the
    # tail sum for the WHOLE batch. For relevant pairs s > mode implies
    # ratio < 1, so run only decays; their Z is the only one consumed
    # (non-relevant Z is masked to 0 below).
    run0 = jnp.where(jnp.broadcast_to(relevant, shp), 1.0, 0.0
                     ).astype(jnp.float32)
    _, _, tail = jax.lax.while_loop(
        cond, body, (jnp.int32(0), run0, jnp.ones(shp, jnp.float32)))

    z = -(logp0 + jnp.log(tail)) * LOG10E
    z = jnp.where(jnp.isfinite(z), jnp.minimum(z, 99.0), 99.0)
    f1num = 2.0 * s
    f1den = (jnp.asarray(size1, jnp.float32)
             + jnp.asarray(size2, jnp.float32))
    f1 = jnp.where(f1num < 0.0001, 0.0,
                   f1num / jnp.maximum(f1den, 1.0))
    z = jnp.where(z > 98.0, 98.0 + f1, z)
    return jnp.where(relevant, z, 0.0)
