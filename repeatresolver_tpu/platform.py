"""The one place that decides which device the program runs on.

`name()` reads jax.default_backend() once and returns "gpu" (an NVIDIA
card through JAX's CUDA backend) or "cpu". Every stage picks its route
from that name; a backend this module does not know is an error, so no
route is ever assumed for it.

Routes by platform:
  realign    gpu: staircase band, device fill + walk (ops/
             staircase_realign.py); cpu: exact band, native host engine
  align/cut  gpu: device DP (ops/editdp.py, read_cutter's wavefront);
             cpu: native host kernels
  MaxCorrs   gpu: device scan above a size gate; cpu: host scan
  resolver   gpu: device integer matmuls (ops/devmm.py); cpu: numpy
"""
from __future__ import annotations

import functools
import os
import subprocess

PLATFORMS = ("gpu", "cpu")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve(backend: str) -> str:
    """Map a JAX backend name to a platform this program has routes
    for; raise for any other."""
    if backend in PLATFORMS:
        return backend
    raise RuntimeError(
        f"unsupported JAX backend {backend!r}: this program has routes "
        f"for {' and '.join(PLATFORMS)} only")


@functools.cache
def name() -> str:
    import jax
    return resolve(jax.default_backend())


def on_gpu() -> bool:
    return name() == "gpu"


def realign_route(plat: str, mode: str = "auto",
                  kernel: str = "auto") -> tuple[str, str]:
    """The realigner's (mode, kernel) on `plat`, filling in "auto": on
    the GPU the staircase band with the CUDA fill, on the CPU the exact
    band on the native host engine. Explicit values are kept; an auto
    kernel for a mode the platform has no route of its own for is the
    XLA one. (realign_batched also takes the XLA fill for a band too
    wide for the CUDA kernel, BatchedRealigner.cuda_fits.)"""
    if mode == "auto":
        mode = "staircase" if plat == "gpu" else "exact"
    if kernel == "auto":
        kernel = ("cuda" if plat == "gpu" and mode == "staircase" else
                  "native" if plat == "cpu" and mode == "exact" else
                  "xla")
    return mode, kernel


def local_card_count() -> int:
    """The GPUs this host shows a process, counted without starting a
    JAX backend: CUDA_VISIBLE_DEVICES when it is set, else nvidia-smi."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([v for v in vis.split(",") if v.strip()])
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, check=True).stdout
    return len([ln for ln in out.splitlines() if ln.startswith("GPU ")])


def held_to_cpu() -> bool:
    """Whether JAX is configured for the CPU alone."""
    import jax
    return jax.config.jax_platforms == "cpu"


def process_devices(process_id: int | None,
                    n_local: int | None = None) -> list[int] | None:
    """The local devices process `process_id` of a multi-process run
    takes, decided before any backend starts (jax.distributed must
    initialize first): one card, its local rank `process_id % n_local`
    (processes fill each host's `n_local` cards in turn), unless JAX is
    held to the CPU, whose virtual devices every process shares."""
    if process_id is None or held_to_cpu():
        return None
    if n_local is None:
        n_local = local_card_count()
    if n_local < 1:
        raise RuntimeError("no GPU visible to this process")
    return [process_id % n_local]


def device_memory_share(fraction: float) -> int:
    """`fraction` of the device's memory limit, in bytes. Raises when
    the device reports no limit (the CPU backend does not): sizes are
    derived from the card, never assumed."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{jax.devices()[0].device_kind} reports no memory limit")
    return int(stats["bytes_limit"] * fraction)


def card() -> str:
    """The GPU's name and power limit as nvidia-smi reports them, for
    every timing a measurement prints; cards that report the same line
    are counted once ("<line> x4")."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split("\n")
    lines = [ln.strip() for ln in lines if ln.strip()]
    if len(set(lines)) == 1 and len(lines) > 1:
        return f"{lines[0]} x{len(lines)}"
    return " | ".join(lines)


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when it is set (JAX reads it itself; nothing else is set), else at
    <repo>/.jax_cache, a fixed path so later runs hit it. Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
