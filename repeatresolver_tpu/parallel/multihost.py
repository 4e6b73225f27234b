"""Multi-host process parallelism.

The reference's outermost parallelism is a human operator launching
RepeatResolver once per window, possibly on different machines, and
merging the results through the on-disk subdivision files
(the reference README.md:104-106 + Window.py). The JAX equivalent is
jax.distributed across processes (SURVEY.md §2.3): processes
join a coordination service, each takes a round-robin slice of the
windows, and the merge is the same file contract — the flank-connection
chain (models/assessment.multi_step_resolution) reads every window's
subdivision regardless of which process wrote it.

Window resolution is embarrassingly parallel (windows are independent,
RepeatResolver.c operates on one [von, bis] range per invocation), so
no collective is needed beyond the final barrier; realignment and
MaxCorrs shard WITHIN a window over the local mesh instead
(parallel/sharded.py).

Tested with a genuine 2-process jax.distributed CPU run in
tests/test_multihost.py: subdivision files byte-identical to the
single-process run.
"""
from __future__ import annotations

import os


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """jax.distributed entry path. With a coordinator address (or the
    standard JAX env vars), joins the distributed runtime and returns
    (process_index, process_count); without one, stays single-process.
    Idempotent. On a GPU host each process takes one local card, the
    one numbered by its process id: a process that opened every card
    would reserve most of each card's memory and the next process
    would run out."""
    import jax

    from .. import platform
    if coordinator_address is None and not os.environ.get(
            "JAX_COORDINATOR_ADDRESS"):
        return 0, 1
    local = platform.process_devices(process_id)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id,
            local_device_ids=local)
    except RuntimeError:
        pass  # already initialized
    return jax.process_index(), jax.process_count()


def window_slice(n_windows: int, process_id: int,
                 process_count: int) -> list[int]:
    """Deterministic round-robin window ownership."""
    return list(range(process_id, n_windows, process_count))


def resolve_windows(msareal_path: str, resolver_cfg, window_cfg,
                    process_id: int = 0, process_count: int = 1,
                    workdir: str | None = None,
                    progress=print) -> list[str]:
    """Resolve this process's window slice of the MSA, writing the
    reference-format subdivision files (RepeatResolver.c:4040-4075
    names). Every process computes the same deterministic window
    boundaries from the MSA; ownership is round-robin."""
    from ..models import resolver, window
    from ..utils import io as rio

    msareal = rio.read_msa(msareal_path)
    mc = rio.read_maxcorrs(os.path.join(
        os.path.dirname(msareal_path) or ".",
        rio.maxcorrs_path(os.path.basename(msareal_path))))
    bounds = window.window_boundaries(msareal, window_cfg)
    windows = list(zip(bounds[:-1], bounds[1:]))
    if workdir is None:
        workdir = os.path.dirname(msareal_path) or "."
    base = os.path.basename(msareal_path)
    written = []
    for w in window_slice(len(windows), process_id, process_count):
        von, bis = windows[w]
        out = resolver.resolve_window(msareal, mc, von, bis,
                                      resolver_cfg)
        for kind, u in out.items():
            p = os.path.join(workdir,
                             rio.subdivision_path(kind, von, bis, base))
            rio.write_subdivision(p, u)
            written.append(p)
        progress(f"[proc {process_id}/{process_count}] resolved window "
                 f"{von}-{bis}")
    return written
