"""The plain reference agrees with known optima, and imports nothing of the
program."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
from scipy.optimize import linprog

from lpbench.harness import ROOT
from lpbench.inputs import generate
from lpbench.reference import ipm

# the pinned optima of the synthetic netlib stand-ins (max form), verified
# against scipy's HiGHS (pycllp_tpu_torch/io/netlib.py FIXTURE_OBJECTIVES)
STANDIN_OPTIMA = {"afiro": -1.9398662763559709, "adlittle": 28.093108065754983,
                  "sc50a": -7.350643059808046}
SCALES = {"afiro": (27, 32), "adlittle": (56, 97), "sc50a": (50, 48)}


def test_two_variable_lp():
    # min x1 + x2 s.t. x1 + 2 x2 ≥ 2, 3 x1 + x2 ≥ 3: x = (0.8, 0.6), 1.4
    A = np.array([[1.0, 2.0, -1.0, 0.0], [3.0, 1.0, 0.0, -1.0]])
    r = ipm.solve(A, np.array([[2.0, 3.0]]), np.array([[1.0, 1.0, 0.0, 0.0]]))
    assert r["converged"].all()
    assert abs(r["objective"][0] - 1.4) <= 1e-9


@pytest.mark.parametrize("name", sorted(STANDIN_OPTIMA))
def test_netlib_standins(name):
    A, b, c = generate.equality_form(*generate.netlib_fixture(name, *SCALES[name]))
    r = ipm.solve(A, b[None], c[None])
    assert r["converged"].all()
    assert abs(-r["objective"][0] - STANDIN_OPTIMA[name]) <= 1e-8 * abs(STANDIN_OPTIMA[name])


@pytest.mark.parametrize("seed", [4, 2**31 + 5])
def test_against_highs(seed):
    A, b, c = generate.equality_form(*generate.random_standard_lp(12, 9, nlp=24, seed=seed))
    r = ipm.solve(A, b, c)
    assert r["converged"].all() and r["certified"].all()
    for i in range(24):
        h = linprog(c[i], A_eq=A, b_eq=b[i], bounds=[(0, None)] * c.shape[1], method="highs")
        assert abs(r["objective"][i] - h.fun) <= 1e-8 * max(1.0, abs(h.fun))


def test_reports_a_lane_it_cannot_solve():
    # x1 + x2 = -1 with x ≥ 0 has no solution: the lane does not converge
    r = ipm.solve(np.array([[1.0, 1.0]]), np.array([[2.0], [-1.0]]),
                  np.array([[1.0, 2.0], [1.0, 2.0]]), maxiter=40)
    assert r["converged"].tolist() == [True, False]


def test_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import lpbench.reference.ipm; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & {"pycllp_tpu_torch", "pycllp_tpu", "jax", "jaxlib", "torch"}
