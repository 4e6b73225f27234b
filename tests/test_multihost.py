"""Multi-host process parallelism: a genuine 2-process
jax.distributed CPU run of the windowed resolve must produce
subdivision files byte-identical to the single-process run
(the reference's operator parallelism, README.md:104-106)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repeatresolver_tpu.config import (MaxCorrConfig, ResolverConfig,
                                       WindowConfig)
from repeatresolver_tpu.models import maxcorr
from repeatresolver_tpu.parallel import multihost
from repeatresolver_tpu.utils import io as rio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_dataset(d: str) -> str:
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
    path = os.path.join(d, "MSAreal_mh")
    rio.write_msa(path, msa, upper=True)
    mc = maxcorr.compute_maxcorrs(msa, MaxCorrConfig(mincov=20))
    rio.write_maxcorrs(os.path.join(d, "MaxCorrsOf_MSAreal_mh"), mc)
    return path


def test_window_slice_partition():
    n = 7
    slices = [multihost.window_slice(n, p, 3) for p in range(3)]
    flat = sorted(w for s in slices for w in s)
    assert flat == list(range(n))


def test_two_process_distributed_resolve(tmp_path):
    a = tmp_path / "single"
    b = tmp_path / "dist"
    a.mkdir()
    b.mkdir()
    msa_a = _make_dataset(str(a))
    msa_b = os.path.join(str(b), "MSAreal_mh")
    shutil.copy(msa_a, msa_b)
    shutil.copy(os.path.join(str(a), "MaxCorrsOf_MSAreal_mh"),
                os.path.join(str(b), "MaxCorrsOf_MSAreal_mh"))

    rcfg = ResolverConfig(cov=20)
    wcfg = WindowConfig(coverage=0.9, parts=2)
    written = multihost.resolve_windows(msa_a, rcfg, wcfg,
                                        progress=lambda *_: None)
    assert len(written) == 6          # 2 windows x 3 clusterings

    port = 21000 + os.getpid() % 2000
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "repeatresolver_tpu.cli",
             "resolve-windows", msa_b, "-c", "20", "-p", "2",
             "--coordinator", f"127.0.0.1:{port}",
             "--procs", "2", "--proc-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    # each process owned a disjoint non-empty slice
    assert all("-> " in out for out, _ in outs)

    names = sorted(os.path.basename(w) for w in written)
    for name in names:
        fa = os.path.join(str(a), name)
        fb = os.path.join(str(b), name)
        assert os.path.exists(fb), f"distributed run missing {name}"
        with open(fa, "rb") as f1, open(fb, "rb") as f2:
            assert f1.read() == f2.read(), name
