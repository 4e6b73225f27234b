"""The staircase fill as a CUDA kernel (native/staircase_fill.cu).

Same inputs and bit-identical outputs as the XLA fill
(staircase_realign.staircase_fill), which stays beside it as the plain
reference. The XLA side computes the per-row cost planes (the same
_row_costs the XLA fill uses) and pads the step inputs to whole chunks;
the kernel runs one thread block per row with the chunk loop inside.

The library is built with nvcc from the committed sources at first use,
into native/build/ under a name keyed to the sources, and registered as
an XLA FFI target for the CUDA platform. It has no interpret mode: on
the CPU only `kernel_inputs` (the shapes and padding) is exercised.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from .banded_realign import _row_costs
from .staircase_realign import WORD

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCES = ("staircase_fill.cu", "staircase_fill.cuh")
_GENCODE = "arch=compute_90a,code=sm_90a"
TARGET = "rr_staircase_fill"
THREADS = 256            # rr::kThreads
MAX_W2 = THREADS * 20    # widest template instance (K = 20 lanes/thread)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("the CUDA staircase fill needs nvcc (CUDA toolkit)")


def build() -> str:
    """Compile the kernel library if no build of these sources exists;
    returns its path."""
    native = os.path.join(_REPO, "native")
    h = hashlib.sha256(_GENCODE.encode())
    for name in _SOURCES:
        with open(os.path.join(native, name), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(native, "build")
    so = os.path.join(out_dir, f"libstaircase_fill-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [_nvcc(), "-gencode", _GENCODE, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(), "-o", tmp,
           os.path.join(native, "staircase_fill.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def register() -> None:
    """Build (if needed) and register the FFI target, once per process."""
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.RrStaircaseFill), platform="CUDA")


def kernel_inputs(counts, rows_old, seqs, ways, lengths, ncols, *,
                  bandwidth, chunk):
    """The kernel's operands, in the handler's order: per-row cost
    planes gap, ins, ns [B, C] int32, own [B, C] int8, gap prefix
    [B, C+1], base counts [C, 4], then the step inputs padded to whole
    chunks — seqs [B, Lpad] int8, reference band starts [B, Lpad], the
    window start of each chunk [B, NC] — lengths [B] and ncols [1]."""
    bh = bandwidth // 2
    b, l = seqs.shape
    nchunks = -(-l // chunk)
    lpad = nchunks * chunk
    seqs = jnp.asarray(seqs, jnp.int8)
    ways = jnp.asarray(ways, jnp.int32)
    if lpad != l:
        seqs = jnp.pad(seqs, ((0, 0), (0, lpad - l)))
        ways = jnp.pad(ways, ((0, 0), (0, lpad - l)), mode="edge")
    ns, gapcost, inscost, g = _row_costs(jnp.asarray(counts),
                                         jnp.asarray(rows_old))
    lob = jnp.maximum(0, ways - bh)
    c4 = jnp.asarray(counts).astype(jnp.int32)[:, 0:4]
    return (gapcost.astype(jnp.int32), inscost.astype(jnp.int32),
            ns.astype(jnp.int32), jnp.asarray(rows_old, jnp.int8),
            g.astype(jnp.int32), c4, seqs, lob, lob[:, ::chunk],
            jnp.asarray(lengths, jnp.int32),
            jnp.asarray(ncols, jnp.int32).reshape(1))


def out_shapes(b: int, l: int, w2: int, chunk: int):
    """codes [Lpad/16, B, W2], final band [B, W2], final window [B]."""
    lpad = -(-l // chunk) * chunk
    return (jax.ShapeDtypeStruct((lpad // WORD, b, w2), jnp.int32),
            jax.ShapeDtypeStruct((b, w2), jnp.int32),
            jax.ShapeDtypeStruct((b,), jnp.int32))


@functools.partial(jax.jit,
                   static_argnames=("bandwidth", "chunk", "widen"))
def staircase_fill_cuda(counts, rows_old, seqs, ways, lengths, ncols, *,
                        bandwidth, chunk=256, widen=1):
    """Drop-in for staircase_realign.staircase_fill on the GPU."""
    w2 = bandwidth + widen * chunk
    if chunk % WORD or w2 > MAX_W2:
        raise ValueError(f"CUDA fill: chunk {chunk} must be a multiple "
                         f"of {WORD} and W2 {w2} at most {MAX_W2}")
    register()
    args = kernel_inputs(counts, rows_old, seqs, ways, lengths, ncols,
                         bandwidth=bandwidth, chunk=chunk)
    b, l = seqs.shape
    return jax.ffi.ffi_call(TARGET, out_shapes(b, l, w2, chunk))(
        *args, bandwidth=np.int64(bandwidth), chunk=np.int64(chunk))
