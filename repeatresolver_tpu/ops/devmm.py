"""Device-routed exact integer matmuls for the resolver.

The reference RepeatResolver's heavy arithmetic is bitset popcounts in
disguise: clique-candidate intersections (RepeatResolver.c:1204-1226
via Schnitt), clique coverage products, and the kmeans GrMatch
matrices (RepeatResolver.c:141-153, 2656-2723). In this framework they
are binary matmuls (models/resolver.py): int8 operands with int32
accumulation are EXACT (integer products never go through TF32), so
the device
result is value-identical to the numpy f64/f32 host path for any
operand whose dot products stay below 2^31 (guaranteed: counts are
bounded by MSA rows).

Routing: `matmul_t(a, b)` computes a @ b.T and returns a host int32
array. It runs on the device when (a) the platform is the GPU (or
RR_RESOLVER_DEVICE=1 forces it), and (b) the product is big enough to
amortize the dispatch and transfers (RR_DEVICE_MM_MIN element-ops,
default 3e9, not yet measured on the GPU). Operands wrapped in
`Operand` keep their device copy alive across calls — the resolver
reuses the [G, R] group matrix across every seed chunk of a window, so
it is uploaded once.

Everything falls back to numpy when jax is unavailable or the product
is small; there is no behavioral difference, only placement.
"""
from __future__ import annotations

import os

import numpy as np

_state: dict = {}


def device_enabled() -> bool:
    if "on" not in _state:
        env = os.environ.get("RR_RESOLVER_DEVICE", "auto")
        if env == "0":
            on = False
        elif env == "1":
            on = True
        else:
            from .. import platform
            on = platform.on_gpu()
        _state["on"] = on
    return _state["on"]


MIN_DEVICE_OPS = float(os.environ.get("RR_DEVICE_MM_MIN", 3e9))


class Operand:
    """A host int matrix with a lazily-created, cached device copy.

    The host view is int8 (all resolver operands are 0/1); the device
    copy is created on first device-routed use and reused for every
    later matmul with this operand."""

    def __init__(self, arr: np.ndarray):
        self.host = np.ascontiguousarray(arr, dtype=np.int8)
        self._dev = None

    @property
    def shape(self):
        return self.host.shape

    def dev(self):
        if self._dev is None:
            import jax
            import jax.numpy as jnp
            self._dev = jax.device_put(jnp.asarray(self.host))
        return self._dev


def _as_operand(x) -> Operand:
    return x if isinstance(x, Operand) else Operand(np.asarray(x))


def _host(x) -> np.ndarray:
    return x.host if isinstance(x, Operand) else np.asarray(x)


def _dot_jit():
    fn = _state.get("dot")
    if fn is None:
        import jax

        def dot(a, b):
            import jax.numpy as jnp
            return jax.lax.dot_general(
                a, b, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32)

        fn = _state["dot"] = jax.jit(dot)
    return fn


def matmul_t(a, b, force: bool | None = None) -> np.ndarray:
    """Exact a @ b.T for 0/1 (or small-int) matrices -> int32 host
    array. a, b: Operand or ndarray, shapes [M, R] and [N, R]."""
    ah, bh = _host(a), _host(b)
    m, r = ah.shape
    n = bh.shape[0]
    use_dev = device_enabled() if force is None else force
    if use_dev and (2.0 * m * n * r) < MIN_DEVICE_OPS and force is None:
        use_dev = False
    if not use_dev:
        # float32 sums of 0/1 products are exact below 2^24; resolver
        # counts are bounded by MSA rows (<< 2^24). BLAS sgemm here is
        # the fastest host path.
        return (ah.astype(np.float32)
                @ bh.astype(np.float32).T).astype(np.int32)
    ao, bo = _as_operand(a), _as_operand(b)
    out = _dot_jit()(ao.dev(), bo.dev())
    return np.asarray(out)
