"""The platform module: one route decision per device, errors for the
rest, and the settings derived from it."""
import os

import jax
import numpy as np
import pytest

from repeatresolver_tpu import platform
from repeatresolver_tpu.parallel import sharded


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_known_platforms_resolve_to_themselves(backend):
    assert platform.resolve(backend) == backend


@pytest.mark.parametrize("backend", ["rocm", "metal", "neuron", ""])
def test_unknown_platform_raises(backend):
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.resolve(backend)


def test_this_process_runs_on_the_cpu():
    assert platform.name() == "cpu" and not platform.on_gpu()


@pytest.mark.parametrize("plat,mode,kernel,want", [
    ("gpu", "auto", "auto", ("staircase", "cuda")),
    ("cpu", "auto", "auto", ("exact", "native")),
    ("gpu", "exact", "auto", ("exact", "xla")),
    ("cpu", "staircase", "auto", ("staircase", "xla")),
    ("gpu", "auto", "xla", ("staircase", "xla")),
])
def test_realign_route_chosen_by_platform_name(plat, mode, kernel, want):
    assert platform.realign_route(plat, mode, kernel) == want


def test_make_mesh_raises_when_short_of_devices():
    n = len(jax.devices())
    assert sharded.make_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="need"):
        sharded.make_mesh(n + 1)


def test_device_memory_share_needs_a_reported_limit():
    # the CPU backend reports no memory limit: sizes derived from the
    # card must not be guessed for it
    with pytest.raises(RuntimeError, match="no memory limit"):
        platform.device_memory_share(0.25)


def test_process_devices_on_the_cpu():
    assert platform.process_devices(None) is None
    assert platform.process_devices(1) is None     # JAX held to the CPU


@pytest.mark.parametrize("pid,n_local,want", [
    (0, 4, 0), (3, 4, 3), (4, 4, 0), (7, 4, 3), (5, 1, 0), (9, 8, 1)])
def test_process_devices_take_their_local_rank(monkeypatch, pid,
                                                n_local, want):
    """On a GPU host each process takes one local card, numbered by
    its rank on the host, so processes past the first host's cards
    still find one."""
    monkeypatch.setattr(platform, "held_to_cpu", lambda: False)
    assert platform.process_devices(pid, n_local) == [want]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", ",".join(
        str(i) for i in range(n_local)))
    assert platform.local_card_count() == n_local
    assert platform.process_devices(pid) == [want]


def test_compile_cache_follows_env_else_fixed_repo_path(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert platform.setup_compile_cache() == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == old
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = platform.setup_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_auto_realign_route_on_the_cpu():
    """realign_batched's auto route on the CPU is the exact band on the
    native host engine; the stats name the engine that ran."""
    from test_batched_realigner import make_msa

    from repeatresolver_tpu.config import RealignerConfig
    from repeatresolver_tpu.models import realigner

    stats: dict = {}
    out = realigner.realign_batched(make_msa(3, rows=8, tlen=120),
                                    RealignerConfig(bandwidth=48),
                                    block_rows=4, stats=stats)
    assert stats["route"] == "BatchedRealigner exact/native"
    realigner.validate_counts(out, realigner.symbol_counts(out))
    assert np.isfinite(stats["cells_per_s"])
