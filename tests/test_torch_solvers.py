"""Port parity: the remaining single-device solvers and the utils.

* ``dense_path`` (solvers/dense_path.py) in f64 against the reference on
  the reference kernel sets: equal statuses and iteration counts,
  objectives to 1e-9 relative (shared and per-instance A, Mehrotra on
  and off); in f32 on the port's ``BATCHLAST_KERNELS`` (plain versions
  on the CPU) against the reference's (Pallas in interpret mode): status
  agreement and objectives where both are OPTIMAL (bounds in the test);
* the registry backends ``scipy`` and ``cpp_hsd`` against the reference's
  (objectives to 1e-12: the same scipy, the same C++ source), and every
  backend of the port's ``available_solvers()`` agreeing with the first
  to 1e-6, as ``tests/test_hsd.py``'s cross-backend check;
* ``cpp_hsd`` builds under ``build/`` and writes nothing into
  ``pycllp_tpu/native/``;
* utils: the FLOP model equals the reference's over a grid, ``trace``
  writes a Chrome trace, ``checked_solve`` gives an empty report on a
  clean batch and the reference's report keys on a NUMERICAL lane.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import pycllp_tpu as ref_pkg
import pycllp_tpu_torch as port_pkg
from pycllp_tpu.io.generate import random_equality_lp, random_standard_lp
from pycllp_tpu.ops.batchlast import BATCHLAST_KERNELS as REF_BL
from pycllp_tpu.solvers import cpp as ref_cpp
from pycllp_tpu.solvers import dense_path as ref_dense
from pycllp_tpu.utils import debug as ref_debug
from pycllp_tpu.utils import profiling as ref_profiling
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS as REFERENCE_KERNELS_PORT
from pycllp_tpu_torch.solvers import cpp as port_cpp
from pycllp_tpu_torch.solvers.dense_path import dense_path_solve_batched
from pycllp_tpu_torch.utils import debug, profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPTIMAL = int(port_pkg.Status.OPTIMAL)


def _np(out):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


def _batch(shared=True):
    A, b, c = random_equality_lp(8, 20, nlp=12, seed=41, shared_A=shared)
    return A, b, c


@pytest.mark.parametrize("shared", [True, False], ids=["shared_A", "batched_A"])
@pytest.mark.parametrize("mehrotra", [True, False])
def test_dense_path_f64_matches_jax(shared, mehrotra):
    A, b, c = _batch(shared)
    kw = dict(tol=1e-8, maxiter=60, mehrotra=mehrotra)
    ref = _np(ref_dense.dense_path_solve_batched(A, b, c, ref_pkg.SolverOptions(**kw)))
    port = _np(dense_path_solve_batched(A, b, c, port_pkg.SolverOptions(**kw), device="cpu"))
    assert set(port) == set(ref)
    np.testing.assert_array_equal(port["status"], ref["status"])
    np.testing.assert_array_equal(port["iterations"], ref["iterations"])
    np.testing.assert_allclose(port["objective"], ref["objective"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(port["x"], ref["x"], rtol=1e-7, atol=1e-9)
    assert (port["status"] == OPTIMAL).all()


def test_dense_path_f32_batchlast_matches_jax_interpret():
    """bench.py's config-1 batch in f32 at tol 1e-4: the dense path has no
    homogeneous embedding and most f32 lanes run to the iteration limit in
    both packages, so the bounds are on status agreement (≥ 90%; 96.9%
    measured on the CPU) and on lanes both end OPTIMAL (objectives to the
    tolerance itself, 1e-4; 3.9e-6 measured)."""
    eq = random_standard_lp(30, 50, nlp=64, seed=1).to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    kw = dict(tol=1e-4, maxiter=40, dtype="float32")
    ref = _np(ref_dense.dense_path_solve_batched(A, b, c, ref_pkg.SolverOptions(**kw), REF_BL))
    port = _np(dense_path_solve_batched(A, b, c, port_pkg.SolverOptions(**kw), BATCHLAST_KERNELS,
                                        device="cpu"))
    assert (port["status"] == ref["status"]).mean() >= 0.9
    both = (port["status"] == OPTIMAL) & (ref["status"] == OPTIMAL)
    assert both.sum() >= 4
    np.testing.assert_allclose(port["objective"][both], ref["objective"][both], rtol=1e-4)


def test_dense_path_reduce_any_gates_the_loop():
    """dense_path's loop predicate goes through ``reduce_any`` (the
    reference's argument): called before every pass of the loop (the last
    pass classifies the last lanes OPTIMAL and steps none) and once to end
    it, with the same answer as the local reduction."""
    A, b, c = _batch(True)
    opts = port_pkg.SolverOptions(tol=1e-8, maxiter=60)
    calls = []

    def reduce_any(mask):
        calls.append(tuple(mask.shape))
        return bool(mask.any())

    out = _np(dense_path_solve_batched(A, b, c, opts, REFERENCE_KERNELS_PORT, reduce_any,
                                       device="cpu"))
    ref = _np(dense_path_solve_batched(A, b, c, opts, device="cpu"))
    assert calls == [(12,)] * (int(out["iterations"].max()) + 2)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


def test_dense_path_registry_matches_jax():
    lp = random_standard_lp(10, 15, nlp=4, seed=33)
    ref = ref_pkg.get_solver("dense_path", tol=1e-8)
    ref.init(lp)
    r = ref.solve()
    port = port_pkg.get_solver("dense", tol=1e-8, device="cpu")
    assert port.kernels.name == "reference"
    port.init(lp)
    p = port.solve()
    np.testing.assert_array_equal(p.status, np.asarray(r.status))
    np.testing.assert_allclose(p.objective, np.asarray(r.objective), rtol=1e-9)


@pytest.fixture
def ref_cpp_in_tmp(tmp_path, monkeypatch):
    """The reference's cpp backend, built into a temporary directory (it
    would otherwise write its library next to its source)."""
    monkeypatch.setattr(ref_cpp, "_LIB", str(tmp_path / "libpycllp_native.so"))
    monkeypatch.setattr(ref_cpp, "_lib", None)


@pytest.mark.parametrize("name", ["scipy", "cpp_hsd"])
def test_host_backends_match_jax_registry(name, ref_cpp_in_tmp):
    lp = random_standard_lp(10, 15, nlp=4, seed=33)
    ref = ref_pkg.get_solver(name, tol=1e-8)
    ref.init(lp)
    r = ref.solve()
    port = port_pkg.get_solver(name, tol=1e-8, device="cuda")  # host backends: device unused
    port.init(lp)
    p = port.solve()
    np.testing.assert_array_equal(p.status, np.asarray(r.status))
    np.testing.assert_array_equal(p.iterations, np.asarray(r.iterations))
    np.testing.assert_allclose(p.objective, np.asarray(r.objective), rtol=1e-12)
    np.testing.assert_allclose(p.x, np.asarray(r.x), rtol=1e-12, atol=1e-12)


def test_cpp_builds_under_build_dir():
    native = ROOT / "pycllp_tpu" / "native"
    before = sorted(p.name for p in native.iterdir())
    lib = port_cpp.load_native()
    path = port_cpp.native_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert lib.hsd_native_num_threads() >= 1
    assert sorted(p.name for p in native.iterdir()) == before
    # an aborted build leaves no temporary file behind
    assert not [p for p in path.parent.iterdir() if p.name.startswith("tmp")]


def test_cpp_source_is_the_ports_own_copy():
    """cpp_hsd compiles the port's copy of the C++ source, which lies in the
    port and is byte-identical to the reference's."""
    src = pathlib.Path(port_cpp._SRC).resolve()
    assert src.is_relative_to(ROOT / "pycllp_tpu_torch")
    assert src.read_bytes() == (ROOT / "pycllp_tpu" / "native" / "hsd_native.cpp").read_bytes()


_PATH_CALLS = {"Path", "PurePath", "join", "joinpath", "open", "exists", "is_file", "isfile",
               "isdir", "listdir", "glob", "read_text", "read_bytes", "CDLL", "import_module",
               "__import__"}


def _reference_paths(tree) -> list:
    """(line, text) of every string constant that a path into the reference
    package starts with, used as a path segment: an operand of ``/`` or an
    argument of a path call.  Messages that merely cite a reference line
    are neither, and ``pycllp_tpu_torch`` is not the reference."""
    import ast
    import re

    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            operands = [node.left, node.right]
        elif isinstance(node, ast.Call):
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if name not in _PATH_CALLS:
                continue
            operands = list(node.args)
        else:
            continue
        for op in operands:
            if (isinstance(op, ast.Constant) and isinstance(op.value, str)
                    and re.match(r"pycllp_tpu(?!\w)", op.value)):
                hits.append((node.lineno, op.value))
    return hits


def test_port_reads_nothing_of_the_reference_package():
    """No .py file of the port (nor chip_smoke.py) imports the reference
    package or builds a path into it."""
    import ast

    # the detector itself: a path segment is found, a cited line is not
    assert _reference_paths(ast.parse('ROOT / "pycllp_tpu" / "native"')) == [(1, "pycllp_tpu")]
    assert _reference_paths(ast.parse('open("pycllp_tpu/native/x.cpp")'))
    assert not _reference_paths(ast.parse('raise E("see pycllp_tpu/ops/df64.py:72")'))
    assert not _reference_paths(ast.parse('P / "pycllp_tpu_torch" / "csrc"'))
    files = sorted((ROOT / "pycllp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        assert not _reference_paths(tree), (path, _reference_paths(tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("pycllp_tpu", "jax", "jaxlib"), (path, mod)


def test_registry_names_match_the_reference():
    """Every registry name and alias of the reference names the port's
    counterpart; the port has no other."""
    ref = {name: cls.name for name, cls in ref_pkg.solvers.solver_registry.items()}
    port = {name: cls.name for name, cls in port_pkg.solvers.solver_registry.items()}
    assert {"schur", "column_sharded", "big_lp"} <= port.keys()
    assert port == ref
    solver = port_pkg.get_solver("jax_hsd", device="cpu")
    assert type(solver) is port_pkg.solvers.solver_registry["hsd"]
    assert solver.name == "hsd"


def test_cross_backend_agreement():
    """Every available backend agrees on one batch (tests/test_hsd.py)."""
    names = port_pkg.available_solvers()
    assert names == ["cpp_hsd", "dense_path", "hsd", "hsd_pallas", "schur", "scipy"]
    lp = random_standard_lp(10, 15, nlp=4, seed=33)
    objs = {}
    for name in names:
        s = port_pkg.get_solver(name, tol=1e-8, device="cpu")
        s.init(lp)
        sol = s.solve()
        assert (sol.status == OPTIMAL).all(), name
        objs[name] = sol.objective
    for name in names[1:]:
        np.testing.assert_allclose(objs[name], objs[names[0]], rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n_rhs", [1, 2, 3])
def test_flop_model_equals_reference(n_rhs):
    for m in (1, 5, 27, 56, 64):
        for n in (1, 32, 59, 128, 153):
            assert profiling.ipm_iteration_flops(m, n, n_rhs) == \
                ref_profiling.ipm_iteration_flops(m, n, n_rhs)
            it = np.arange(1, 8) * m
            assert profiling.solve_flops(m, n, it, n_rhs) == ref_profiling.solve_flops(m, n, it, n_rhs)
    assert profiling.achieved_tflops(3e12, 1.5) == ref_profiling.achieved_tflops(3e12, 1.5)
    assert not [k for k in dir(profiling) if k.startswith("V5E")]


def test_trace_writes_chrome_trace(tmp_path):
    A, b, c = random_equality_lp(4, 9, nlp=2, seed=0)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        port_pkg.solvers.hsd.hsd_solve_batched(A, b, c, device="cpu")
    path = tmp_path / "prof" / "trace.json"
    assert path.stat().st_size > 0
    assert json.loads(path.read_text())["traceEvents"]
    assert prof.key_averages()


def test_checked_solve_clean_batch():
    A, b, c = random_equality_lp(6, 15, seed=2)
    out, report = debug.checked_solve(A, b[None], c[None], port_pkg.SolverOptions(tol=1e-8),
                                      device="cpu")
    assert report == []
    assert int(out["status"][0]) == OPTIMAL


def _wrecked():
    """tests/test_utils.py's pathologically scaled instance, in f32 with
    (almost) no regularization."""
    A, b, c = random_equality_lp(8, 20, seed=3)
    A = A * np.logspace(-6, 6, 20)[None, :]
    return A.astype(np.float32), b[None].astype(np.float32), c[None].astype(np.float32)


def test_diagnosis_has_reference_keys():
    A, b, c = _wrecked()
    kw = dict(tol=1e-10, dtype="float32", scale=False, reg_eps=1e-30, stall_patience=1000)
    out, report = debug.checked_solve(A, b, c, port_pkg.SolverOptions(maxiter=60, **kw),
                                      device="cpu")
    assert int(out["status"][0]) == int(port_pkg.Status.NUMERICAL)
    assert len(report) == 1 and report[0]["lane"] == 0
    # the reference's report on the same lane, with a short budget to keep
    # its per-maxiter recompiles few
    short = dict(maxiter=3, **kw)
    ref = ref_debug.diagnose_numerical_lanes(A, b, c, [0], ref_pkg.SolverOptions(**short))
    port = debug.diagnose_numerical_lanes(A, b, c, [0], port_pkg.SolverOptions(**short),
                                          device="cpu")
    assert set(report[0]) == set(ref[0]) == set(port[0])
    for k in ("lane", "f64_status", "f64_iterations", "first_bad_f32_iteration", "hint"):
        assert port[0][k] == ref[0][k], k
