"""Golden parity of the transposon assessment leg vs the reference
TransposonAssessment.py (run under a mechanical py2->py3 text
conversion — print statements and the three int-division sites — the
same compile-the-reference idea as tests/golden/build_reference.sh).

The fixture writes a planted two-group MSA in the reference's real-data
file layout (MidTransposonMMA_<x>_real + TransposonCopies_<x> +
MaxCorrsOf_... + the three subdivision files,
TransposonAssessment.py:26-43) with the window encoded in the
subdivision filename in flat C*5 units (the script divides by 5,
TransposonAssessment.py:156-157)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repeatresolver_tpu.config import MaxCorrConfig, ResolverConfig
from repeatresolver_tpu.models import assessment as am
from repeatresolver_tpu.models import maxcorr, resolver
from repeatresolver_tpu.utils import io as rio

# reuse the planted two-group MSA
from tests.test_golden_maxcorr import planted_msa  # noqa: F401

REF = "/root/reference/TransposonAssessment.py"


def _py3_reference(dst_dir: str) -> str:
    """Textual py2->py3 conversion of the reference script: print
    statements to calls, and the integer divisions whose py3 float
    result would crash range()/slicing (start/5, ende/5, len(..)/2).
    No logic is touched."""
    with open(REF, encoding="latin1") as f:
        src = f.read()
    src = re.sub(r"(?m)^(\s*)print (.+)$", r"\1print(\2)", src)
    src = re.sub(r"(?m)^(\s*)print$", r"\1print()", src)
    src = src.replace("start/5", "start//5").replace(
        "ende/5", "ende//5")
    src = src.replace("len(Kons[k])/2", "len(Kons[k])//2")
    out = os.path.join(dst_dir, "ta_ref_py3.py")
    with open(out, "w") as f:
        f.write(src)
    return out


@pytest.fixture(scope="module")
def transposon_dir(planted_msa, tmp_path_factory):  # noqa: F811
    _, _, msa = planted_msa
    d = str(tmp_path_factory.mktemp("transposon"))
    num = 7
    w = msa.shape[1]
    von, bis = 0, (w - 1) * 5   # flat C*5 units in the filename
    rio.write_msa(os.path.join(d, f"MidTransposonMMA_{num}_real"),
                  msa, upper=True)
    mc = maxcorr.compute_maxcorrs(msa, MaxCorrConfig(mincov=20))
    rio.write_maxcorrs(
        os.path.join(d, f"MaxCorrsOf_MidTransposonMMA_{num}_real"), mc)
    gt = (np.arange(msa.shape[0]) % 2).astype(np.int64)
    rio.write_ints(os.path.join(d, f"TransposonCopies_{num}"), gt)
    out = resolver.resolve_window(msa, mc, 0, w - 1,
                                  ResolverConfig(cov=20))
    names = {}
    for kind in ("Dropoff", "RelDrop", "Kmeans"):
        name = (f"{kind}SubdivisionOf_{von}_{bis}_"
                f"MidTransposonMMA_{num}_real")
        rio.write_subdivision(os.path.join(d, name), out[kind])
        names[kind] = name
    return d, msa, mc, gt, out, names, von, bis


def _run_reference(d: str, kmeans_name: str) -> str:
    if not os.path.exists(REF):
        pytest.skip(f"reference script {REF} not present")
    script = _py3_reference(d)
    res = subprocess.run([sys.executable, script, kmeans_name],
                         cwd=d, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_transposon_assessment_golden(transposon_dir):
    d, msa, mc, gt, out, names, von, bis = transposon_dir
    stdout = _run_reference(d, names["Kmeans"])

    # --- Resolvability: unique-group counts at thresholds 0..10
    m = re.search(r"This data set has \[([0-9, ]+)\] / (\d+) unique",
                  stdout)
    assert m, stdout
    ref_summe = [int(x) for x in m.group(1).split(",")]
    ref_ngroups = int(m.group(2))
    col_mc = mc.reshape(-1, 5).max(axis=1)
    sigs = am.signatures(msa, col_mc, 1.0, von, bis)
    assert sigs.shape[1] > 0          # the window saw signal columns
    mindiffs, summe = am.resolvability(gt, sigs)
    assert summe.tolist() == ref_summe
    assert len(mindiffs) == ref_ngroups

    # --- ResolutionQuality per clustering (raw-group transposon
    # variant): tp/fp and the confidence histogram
    blocks = re.findall(
        r"(\w+)Resolution:\s*\ntruepositives (\d+), falsepositives "
        r"(\d+) bei cutoff 0\.0\..*?\n.*?\n\[([0-9, ]+)\]",
        stdout)
    assert len(blocks) == 3, stdout
    for kind, tp, fp, conconf in blocks:
        res = rio.read_ints(os.path.join(d, names[kind]))
        q = am.resolution_quality(gt, res, mask_unassigned=False)
        assert q.truepositives == int(tp), kind
        assert q.falsepositives == int(fp), kind
        assert q.conconfpositives == [int(x) for x in
                                      conconf.split(",")], kind


def test_transposon_cli(transposon_dir, capsys):
    """The assess-transposon CLI derives sibling paths from the kmeans
    filename like the reference (TransposonAssessment.py:26-43) and
    runs end-to-end."""
    d, msa, mc, gt, out, names, von, bis = transposon_dir
    from repeatresolver_tpu import cli
    rc = cli.main(["assess-transposon",
                   os.path.join(d, names["Kmeans"])])
    assert rc == 0
    text = capsys.readouterr().out
    assert "unique groups" in text
    assert "Kmeans: truepositives" in text
