"""Port parity: the CLI (``python -m pycllp_tpu_torch``).

``main(["--device", "cpu", "solve", f])`` prints the same JSON as the
reference CLI (``python -m pycllp_tpu --platform cpu solve f``, run in a
subprocess so its JAX configuration stays out of this process) on the
same MPS file: same status and iterations, objectives to 1e-8 relative.
Exit codes: 0 on OPTIMAL, 1 otherwise; a CUDA request without a card
raises; ``info`` runs without a card.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pycllp_tpu_torch.__main__ import main
from pycllp_tpu_torch.io import netlib
from pycllp_tpu_torch.io.mps import write_mps
from pycllp_tpu_torch.models import GeneralLP

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def afiro_mps(tmp_path_factory):
    path = tmp_path_factory.mktemp("mps") / "afiro.mps"
    path.write_text(write_mps(netlib.load_fixture("afiro").lp, name="AFIRO"))
    return str(path)


def _port_cli(capsys, argv):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


def _reference_cli(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "pycllp_tpu", "--platform", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    return proc.returncode, json.loads(proc.stdout)


@pytest.mark.parametrize("extra", [[], ["--print-solution"], ["--solver", "dense_path"]],
                         ids=["hsd", "print_solution", "dense_path"])
def test_solve_json_matches_reference_cli(capsys, afiro_mps, extra):
    rc, port = _port_cli(capsys, ["--device", "cpu", "solve", afiro_mps, *extra])
    ref_rc, ref = _reference_cli(["solve", afiro_mps, *extra])
    assert rc == ref_rc == 0
    assert set(port) == set(ref)
    assert port["status"] == ref["status"] == "OPTIMAL"
    assert port["iterations"] == ref["iterations"]
    assert abs(port["objective"] - ref["objective"]) <= 1e-8 * max(1.0, abs(ref["objective"]))
    if "x" in ref:
        assert list(port["x"]) == list(ref["x"])
        np.testing.assert_allclose(list(port["x"].values()), list(ref["x"].values()),
                                   rtol=1e-6, atol=1e-8)


def test_narrow_f32_with_f64_finish_reaches_fixture_optimum(capsys, afiro_mps):
    rc, out = _port_cli(capsys, ["--device", "cpu", "solve", afiro_mps, "--solver", "hsd_pallas",
                                 "--dtype", "float32", "--finish-dtype", "float64"])
    assert rc == 0 and out["status"] == "OPTIMAL"
    ref = netlib.FIXTURE_OBJECTIVES["afiro"]
    assert abs(out["objective"] - ref) <= 1e-6 * max(1.0, abs(ref))


def test_non_optimal_exit_code(capsys, tmp_path):
    # x ≥ 0 and x ≤ −1: infeasible
    path = tmp_path / "infeasible.mps"
    path.write_text(write_mps(GeneralLP(A=[[1.0]], row_ub=[-1.0], c=[1.0])))
    rc, out = _port_cli(capsys, ["--device", "cpu", "solve", str(path)])
    assert rc == 1 and out["status"] != "OPTIMAL"


def test_default_device_without_card_raises(afiro_mps):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the behaviour without one")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        main(["solve", afiro_mps])


def test_info_runs_without_card():
    proc = subprocess.run([sys.executable, "-m", "pycllp_tpu_torch", "info"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, check=True)
    assert "torch " in proc.stdout and "cuda available: " in proc.stdout
    assert "'cpp_hsd', 'dense_path', 'hsd', 'hsd_pallas', 'scipy'" in proc.stdout
    if not torch.cuda.is_available():
        assert "none (CPU only)" in proc.stdout
