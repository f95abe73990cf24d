"""The port's entry points: no JAX, an explicit device, the README quickstart."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pycllp_tpu_torch as port_pkg
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.io.generate import random_equality_lp
from pycllp_tpu_torch.ops import batchlast as bl
from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched, hsd_solve_scan

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    mods = ", ".join(f"pycllp_tpu_torch.{m}" for m in (
        "interop", "__main__", "io.mps", "io.netlib", "solvers.twopass", "solvers.dense_path",
        "solvers.scipy_solver", "solvers.cpp", "utils.profiling", "utils.debug",
    ))
    code = f"import sys, pycllp_tpu_torch, {mods}; assert 'jax' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: these check the behaviour without one")


def test_default_device_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="device='cuda'"):
        port_pkg.get_solver("hsd_pallas")
    A, b, c = random_equality_lp(4, 9, nlp=3, seed=0)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        hsd_solve_batched(A, b, c)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        hsd_solve_scan(A, b, c, chunk=2, compact_cap=3)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        interop.state_from_numpy({})


def test_cuda_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA route launches or raises: it never computes on a CPU tensor."""
    M = torch.eye(4).reshape(4, 4, 1).repeat(1, 1, 8).contiguous()
    reg = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._chol_bl_cuda(M, reg)
    L, dinv = bl.chol_bl(M, reg)  # the dispatching wrapper: CPU → plain version
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._solve_bl_cuda(L, dinv, torch.ones(1, 4, 8))


def test_unported_options_raise(capsys):
    """No option value the reference accepts is refused: the fast-formation
    finish (``finish_kset="df64_fastform"``) runs through both entry
    points, and so do the wide finish and ``log_every``."""
    A, b, c = random_equality_lp(4, 9, nlp=3, seed=0)
    fast = port_pkg.SolverOptions(finish_dtype="float64", dtype="float32", finish_mode="ipm",
                                  finish_kset="df64_fastform")
    out = hsd_solve_batched(A, b, c, fast, bl.BATCHLAST_KERNELS, device="cpu")
    assert out["x"].dtype == torch.float64 and out["status"].shape == (3,)
    out = hsd_solve_scan(A, b, c, fast, bl.BATCHLAST_KERNELS, chunk=2, compact_cap=3, device="cpu",
                         keys=("objective", "status"))
    assert out["objective"].dtype == torch.float64 and out["status"].shape == (3,)
    # the wide finish itself is ported
    out = hsd_solve_batched(A, b, c, port_pkg.SolverOptions(finish_dtype="float64", dtype="float32"),
                            device="cpu")
    assert out["x"].dtype == torch.float64
    # so is log_every: with no sink installed, its records go to stderr
    hsd_solve_batched(A, b, c, port_pkg.SolverOptions(log_every=1), device="cpu")
    assert '"event": "ipm_iteration"' in capsys.readouterr().err


def test_readme_quickstart_runs_on_cpu():
    text = (ROOT / "README.md").read_text()
    section = text[text.index("## PyTorch/CUDA port"):]
    code = re.search(r"```python\n(.*?)```", section, re.S).group(1)
    scope = {}
    exec(compile(code, "README.md quickstart", "exec"), scope)
    sol = scope["sol"]
    status = np.asarray(sol.status)
    assert status.shape == (256,)
    # the narrow f32 solve ends each lane OPTIMAL or, at its f32 floor, STALLED
    assert np.isin(status, (int(port_pkg.Status.OPTIMAL), int(port_pkg.Status.STALLED))).all()
    assert (status == int(port_pkg.Status.OPTIMAL)).mean() > 0.75
    assert np.isfinite(sol.objective).all()
