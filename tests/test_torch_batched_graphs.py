"""The reference's last single-device jit programs as replayed graphs:
``hsd_solve_batched``, the no-cap scan (``_hsd_scan_core``) and
``dense_path_solve_batched``.

* the graph route emulated on the CPU (as in ``test_torch_stages.py``:
  every segment through ``_loop._Segment``'s static buffers and one graph
  cache, a "replay" running the cached entry's ``run``; only the CUDA
  graph itself is left out), bitwise the eager-segment route
  (``hsd._EAGER_SEGMENTS``) and the per-iteration host loop
  (``hsd._HOST_LOOP``): ``hsd_solve_batched`` at bench options (crossover
  finish, restart), in ipm finish mode, on per-instance A, with ``warm``,
  with ``scale=False`` and narrow-only, each alone and all on one cache;
  the no-cap scan with and without ``warm_chain``; ``dense_path`` (its
  gated blocks against its host loop, shared and per-instance A);
* the same solves against the JAX reference on the reference sets, at
  ``test_torch_hsd.py``'s tolerance (statuses and iterations equal,
  objectives to 1e-9, x to 1e-7) and ``test_torch_solvers.py``'s for
  ``dense_path``;
* the keys: for each new segment, a parameter left out of its key makes
  the second of two variants replay the first's launches, and fail
  bitwise;
* no kernel set's ``prepare`` reads a value back to the host (a capture
  on the card would fail there).
"""

import collections
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pycllp_tpu as ref_pkg
import pycllp_tpu_torch as port_pkg
from pycllp_tpu.io.generate import random_equality_lp, random_standard_lp
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu.solvers import dense_path as ref_dense
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.ops import df64, mixed
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_FUSED_KERNELS, BATCHLAST_KERNELS
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS, ReferenceKernels
from pycllp_tpu_torch.solvers import _loop, dense_path
from pycllp_tpu_torch.solvers import hsd as port_hsd

CPU = torch.device("cpu")
# bench.py's bench_options() at its defaults (BENCH_FINISH=1)
BENCH_OPTIONS = dict(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="crossover", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)
BENCH = port_pkg.SolverOptions(**BENCH_OPTIONS)
# graphs one hsd_solve_batched caches at bench options: 6 segments (the
# prologue, the fold, the wide start, the second crossover, the restart,
# the packaging) and 3 loop blocks (narrow, wide, restart)
BENCH_SEGMENTS = 6


def _problem(seed=1, nlp=24, m=12, per_instance=False):
    lp = random_standard_lp(m, m, nlp=nlp, seed=seed, dtype=np.float32)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    if per_instance:
        A = np.ascontiguousarray(np.broadcast_to(A, (nlp,) + A.shape))
    return A, b, c


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _assert_same(out, ref):
    """The same tree (structure, shapes, dtypes) holding the same bits."""
    assert type(out) is type(ref)
    if isinstance(ref, torch.Tensor):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert _bits(out) == _bits(ref)
        return
    if ref is None:
        return
    if isinstance(ref, dict):
        assert out.keys() == ref.keys()
        out, ref = list(out.values()), list(ref.values())
    assert len(out) == len(ref)
    for i, (a, r) in enumerate(zip(out, ref)):
        try:
            _assert_same(a, r)
        except AssertionError as e:
            raise AssertionError(f"[{getattr(ref, '_fields', range(len(ref)))[i]}] {e}") from None


def _differs(out, ref) -> bool:
    try:
        _assert_same(out, ref)
    except AssertionError:
        return True
    return False


@pytest.fixture
def graphs(monkeypatch):
    """The graph route on the CPU: segments through ``_Segment``'s static
    buffers and the graph cache, a replay running the cached entry's
    ``run`` (its output buffers' versions kept, as a graph's replay keeps
    them).  Yields the captures and replays it counted."""
    monkeypatch.setattr(_loop, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setattr(_loop, "_STATIC", {})
    monkeypatch.setattr(_loop, "_captures", lambda tree: True)
    counts = collections.Counter()

    def warm_up(self, device):
        self.keep(self.call())

    def capture(self, device):
        counts["captures"] += 1

    def replay(self):
        # a graph's replay writes its output buffers without marking them
        # modified: keep their version counters as the card would
        counts["replays"] += 1
        with contextlib.ExitStack() as stack:
            for t in _loop._flatten(self._out.tree):
                stack.enter_context(torch.autograd._unsafe_preserve_version_counter(t))
            self.run()

    monkeypatch.setattr(_loop._Segment, "warm_up", warm_up)
    monkeypatch.setattr(_loop._Segment, "capture", capture)
    monkeypatch.setattr(_loop._Segment, "replay", replay)
    return counts


def _route(monkeypatch, route, run):
    """``run()`` on the eager-segment route ("eager") or the host loop
    ("host"); the emulated graph route is the default of the fixture."""
    name = {"eager": "_EAGER_SEGMENTS", "host": "_HOST_LOOP"}[route]
    monkeypatch.setattr(port_hsd, name, True)
    try:
        return run()
    finally:
        monkeypatch.setattr(port_hsd, name, False)


def _batched(A, b, c, opts, kset=BATCHLAST_KERNELS, warm=None):
    return port_hsd.hsd_solve_batched(A, b, c, opts, kset, torch.any, warm, device="cpu")


def _variants(monkeypatch) -> dict:
    """hsd_solve_batched's variants, name -> solve; the warm variant's point
    is a nearby problem's solution, solved on the eager route (it captures
    nothing)."""
    A, b, c = _problem()
    A3, b3, c3 = _problem(seed=2, per_instance=True)
    first = _route(monkeypatch, "eager", lambda: _batched(A, b * 1.01, c, BENCH))
    warm = tuple(first[k] for k in ("x", "y", "z"))
    return {
        "bench": lambda: _batched(A, b, c, BENCH),
        "ipm_finish": lambda: _batched(A, b, c, BENCH.replace(finish_mode="ipm")),
        "per_instance": lambda: _batched(A3, b3, c3, BENCH),
        "warm": lambda: _batched(A, b, c, BENCH, warm=warm),
        "no_scale": lambda: _batched(A, b, c, BENCH.replace(scale=False)),
        "narrow_only": lambda: _batched(A, b, c, BENCH.replace(finish_dtype=None)),
    }


VARIANTS = ("bench", "ipm_finish", "per_instance", "warm", "no_scale", "narrow_only")


def _hold_routes(monkeypatch, graphs, solve):
    """``solve`` on the host loop, the eager-segment route and the emulated
    graph route twice (the second captures nothing): each bitwise the
    host loop's.  Returns the graphs the first graph solve captured."""
    ref = _route(monkeypatch, "host", solve)
    _assert_same(_route(monkeypatch, "eager", solve), ref)
    before = graphs["captures"]
    _assert_same(solve(), ref)
    captured = graphs["captures"] - before
    replays = graphs["replays"]
    _assert_same(solve(), ref)
    assert graphs["captures"] == before + captured and graphs["replays"] > replays
    return captured


@pytest.mark.parametrize("variant", VARIANTS)
def test_batched_graph_route_is_eager_and_host_loop_bitwise(monkeypatch, graphs, variant):
    """One variant of ``hsd_solve_batched``: the emulated graph route, the
    eager segments and the host loop give the same bits, every output; the
    solve captures its segments once (6 with a crossover finish and the
    restart: no branch on data decides which run)."""
    solve = _variants(monkeypatch)[variant]
    captured = _hold_routes(monkeypatch, graphs, solve)
    expected = {"bench": BENCH_SEGMENTS, "ipm_finish": BENCH_SEGMENTS - 1,
                "per_instance": BENCH_SEGMENTS, "warm": BENCH_SEGMENTS,
                "no_scale": BENCH_SEGMENTS, "narrow_only": 2}[variant]
    assert captured == expected


def test_batched_variants_on_one_cache(monkeypatch, graphs):
    """Every variant on one graph cache, then every variant again: a key that
    missed what tells two variants apart would replay the other's launches
    (the shapes of the shared-A variants are the same); the second round
    captures nothing."""
    variants = _variants(monkeypatch).items()
    refs = {name: _route(monkeypatch, "host", solve) for name, solve in variants}
    for _ in range(2):
        for name, solve in variants:
            _assert_same(solve(), refs[name])
    captures = graphs["captures"]
    for name, solve in variants:
        _assert_same(solve(), refs[name])
    assert graphs["captures"] == captures
    # the bench and warm variants share every segment but the prologue
    # (its key: opts and whether warm is given, in the input's spec)
    assert len(_loop._GRAPHS) == graphs["captures"]


def _jax(fn, *args):
    return {k: np.asarray(v) for k, v in fn(*args).items()}


@pytest.mark.parametrize("variant", ("bench", "per_instance", "narrow_only"))
def test_counters_of_prepares_and_crossovers_count_at_replay(monkeypatch, graphs, variant):
    """``hsd.PREPARED_BYTES`` and ``hsd.CROSSOVER_LANES`` on the emulated
    graph route: a call that captures and a call that replays each count
    what a call with eager segments counts."""
    solve = _variants(monkeypatch)[variant]

    def call():
        monkeypatch.setattr(port_hsd, "CROSSOVER_LANES", {})
        solve()
        return (collections.Counter(port_hsd.PREPARED_BYTES),
                {k: v.tolist() for k, v in port_hsd.CROSSOVER_LANES.items()})

    first, second = call(), call()
    assert graphs["captures"] and graphs["replays"]
    eager = _route(monkeypatch, "eager", call)
    assert first == second == eager
    assert eager[0] and bool(eager[1]) == (variant != "narrow_only")


@pytest.mark.parametrize("case", ["shared", "per_instance", "warm", "no_scale"])
def test_batched_graph_route_matches_jax_f64(graphs, case):
    """``hsd_solve_batched`` on the emulated graph route against the JAX
    reference's, f64 on the reference sets from the same numpy inputs:
    statuses and iterations equal, objectives to 1e-9, x to 1e-7 (the
    tolerance of ``test_torch_hsd.py``)."""
    A, b, c = random_equality_lp(10, 24, nlp=16, seed=5, shared_A=case != "per_instance")
    ref_opts = ref_pkg.SolverOptions(tol=1e-8, init_point="mehrotra", kkt_refine=1,
                                     scale=case != "no_scale")
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    warm = None
    if case == "warm":
        first = _jax(ref_hsd.hsd_solve_batched, A, b * 1.01, c, ref_opts, REF_KS)
        warm = tuple(first[k] for k in ("x", "y", "z"))
    import jax.numpy as jnp

    ref = _jax(ref_hsd.hsd_solve_batched, A, b, c, ref_opts, REF_KS, jnp.any, warm)
    for _ in range(2):  # the capture, then a replay
        port = port_hsd.hsd_solve_batched(A, b, c, opts, REFERENCE_KERNELS, torch.any, warm,
                                          device="cpu")
        assert (ref["status"] == int(ref_pkg.Status.OPTIMAL)).all()
        np.testing.assert_array_equal(port["status"].numpy(), ref["status"])
        np.testing.assert_array_equal(port["iterations"].numpy(), ref["iterations"])
        np.testing.assert_allclose(port["objective"].numpy(), ref["objective"], rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(port["x"].numpy(), ref["x"], rtol=1e-7, atol=1e-7)
    assert graphs["replays"] > 0


@pytest.mark.parametrize("warm_chain", [False, True], ids=["cold", "warm_chain"])
def test_scan_core_graph_route_is_eager_and_host_loop_bitwise(monkeypatch, graphs, warm_chain):
    """The no-cap chunked solve (one ``hsd_solve_batched`` a chunk; with
    ``warm_chain`` the carry from chunk to chunk, and the concatenation,
    as segments) on the three routes, bitwise; the chain changes the
    answer."""
    A, b, c = _problem(seed=3, nlp=32)
    b3 = torch.from_numpy(b).reshape(2, 16, -1)
    c3 = torch.from_numpy(c).reshape(2, 16, -1)
    keys = ("x", "objective", "status", "iterations")

    def scan(chain=warm_chain):
        with port_hsd._full_precision_matmuls():
            return port_hsd._hsd_scan_core(A, b3, c3, BENCH, BATCHLAST_KERNELS, keys, CPU, chain)

    _hold_routes(monkeypatch, graphs, scan)
    if warm_chain:
        assert _differs(scan(), scan(False))


def test_warm_carry_keeps_the_reference_statuses():
    """The warm chain's carry takes a lane's point where its status is
    OPTIMAL, STALLED or ITERATION_LIMIT and it is finite (the reference's
    three comparisons), else the blind start."""
    S = port_pkg.Status
    status = torch.tensor([int(s) for s in S], dtype=torch.int32)
    B = status.shape[0]
    x = torch.full((B, 3), 2.0)
    x[0, 0] = float("nan")
    y, z = torch.full((B, 2), -3.0), torch.full((B, 3), 4.0)
    cx, cy, cz = port_hsd._seg_warm_carry((x, y, z, status), ())
    kept = [s in (S.OPTIMAL, S.STALLED, S.ITERATION_LIMIT) for s in S]
    kept[0] = False  # its x is not finite
    for lane, keep in enumerate(kept):
        assert (cx[lane] == (2.0 if keep else 1.0)).all()
        assert (cy[lane] == (-3.0 if keep else 0.0)).all()
        assert (cz[lane] == (4.0 if keep else 1.0)).all()


def _dense(A, b, c, opts, kset=BATCHLAST_KERNELS):
    return dense_path.dense_path_solve_batched(A, b, c, opts, kset, device="cpu")


@pytest.mark.parametrize("block", [1, 3])
@pytest.mark.parametrize("per_instance", [False, True], ids=["shared_A", "per_instance"])
def test_dense_path_gated_blocks_are_the_host_loop_bitwise(monkeypatch, graphs, per_instance,
                                                          block):
    """``dense_path``'s ``PFState`` loop in gated blocks (at the block its
    layout picks, set to ``block``) and its segments on the emulated graph
    route, bitwise its per-iteration host loop and its eager segments; a
    gated-off iteration keeps the state's bits, and counts in no
    ``HOST_STEPS``."""
    monkeypatch.setattr(_loop, "BLOCK", block)
    monkeypatch.setattr(_loop, "BLOCK_PER_INSTANCE", block)
    A, b, c = _problem(seed=4, nlp=16, per_instance=per_instance)
    opts = port_pkg.SolverOptions(dtype="float32", tol=1e-4, maxiter=25)
    assert _hold_routes(monkeypatch, graphs, lambda: _dense(A, b, c, opts)) == 2
    steps = {}
    for route in ("host", "graph"):
        monkeypatch.setattr(port_hsd, "HOST_STEPS", 0)
        if route == "host":
            _route(monkeypatch, "host", lambda: _dense(A, b, c, opts))
        else:
            _dense(A, b, c, opts)
        steps[route] = port_hsd.HOST_STEPS
    assert steps["host"] == steps["graph"] > 0  # the loop's iterations, on both routes


@pytest.mark.parametrize("shared", [True, False], ids=["shared_A", "batched_A"])
def test_dense_path_graph_route_matches_jax(graphs, shared):
    """``dense_path`` on the emulated graph route against the reference's,
    f64 (``test_torch_solvers.py``'s tolerance: statuses and iterations
    equal, objectives to 1e-9, x to 1e-7)."""
    A, b, c = random_equality_lp(8, 20, nlp=12, seed=41, shared_A=shared)
    kw = dict(tol=1e-8, maxiter=60)
    ref = _jax(ref_dense.dense_path_solve_batched, A, b, c, ref_pkg.SolverOptions(**kw))
    for _ in range(2):
        port = dense_path.dense_path_solve_batched(A, b, c, port_pkg.SolverOptions(**kw),
                                                   device="cpu")
        assert set(port) == set(ref)
        np.testing.assert_array_equal(port["status"].numpy(), ref["status"])
        np.testing.assert_array_equal(port["iterations"].numpy(), ref["iterations"])
        np.testing.assert_allclose(port["objective"].numpy(), ref["objective"], rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(port["x"].numpy(), ref["x"], rtol=1e-7, atol=1e-9)
    assert graphs["replays"] > 0


def test_dense_path_carries_the_reference_state():
    """The port carries the reference's ``PFState``: its fields, in order,
    with ``k`` a 0-d int32 tensor."""
    assert dense_path.PFState._fields == ref_dense.PFState._fields
    A, b, c = _problem(seed=4, nlp=8)
    s, data, _ = dense_path._seg_start(tuple(torch.from_numpy(v) for v in (A, b, c)), (),
                                       opts=port_pkg.SolverOptions(), kset=REFERENCE_KERNELS,
                                       dtype=torch.float64)
    assert s.k.dim() == 0 and s.k.dtype == torch.int32 and int(s.k) == 0
    assert len(data) == 5


# ---------------------------------------------------------------------------
# the keys
# ---------------------------------------------------------------------------


class _NanMv(ReferenceKernels):
    """A kernel set whose matvec differs from the reference set's."""

    name = "nan_mv"

    def mv(self, ctx, x):
        return super().mv(ctx, x) * float("nan")


def _recorded(run) -> dict:
    """The first call of each segment ``run`` makes: name -> (fn, state,
    data, params), ``fn`` unbound."""
    calls = {}
    inner = _loop._segment

    def record(fn, state, data, key, eager=False, borrow=False):
        calls.setdefault(fn.func.__name__, (fn.func, state, data, dict(fn.keywords)))
        return inner(fn, state, data, key, eager, borrow)

    _loop._segment = record
    try:
        run()
    finally:
        _loop._segment = inner
    return calls


def _solves():
    A, b, c = _problem(seed=6, nlp=16)
    opts = BENCH.replace(maxiter=6)  # rejects left for the finish
    A3, b3, c3 = (torch.from_numpy(v) for v in _problem(seed=6, nlp=16))
    b3, c3 = b3.reshape(2, 8, -1), c3.reshape(2, 8, -1)

    def scan():
        with port_hsd._full_precision_matmuls():
            sflat = port_hsd._hsd_scan_narrow_core(
                A3.numpy(), b3, c3, port_hsd._narrow_opts_view(opts, opts.switch_tol),
                BATCHLAST_KERNELS, None, 2, 8, CPU)
            port_hsd._hsd_scan_finish_core(
                A3.numpy(), b3, c3, sflat, port_hsd._finish_opts_view(opts), BATCHLAST_KERNELS,
                ("objective", "status"), 3, 8, CPU, rounds=2, truncate="pre")

    calls = _recorded(lambda: _batched(A, b, c, opts))
    calls.update(_recorded(scan))
    calls.update(_recorded(lambda: _dense(A, b, c, port_pkg.SolverOptions(dtype="float32"))))
    # the restart merges a fresh start into its STALLED and NUMERICAL lanes
    fn, (st,), data, params = calls["_seg_tier_restart"]
    stuck = torch.full_like(st.status, int(port_pkg.Status.STALLED))
    calls["_seg_tier_restart"] = fn, (st._replace(status=stuck),), data, params
    return calls


# (segment, the parameter left out of its key, a change of it that changes
# the segment's bits)
KEY_CASES = [
    ("_seg_batched_start", "opts", lambda o: o.replace(scale=not o.scale)),
    ("_seg_fold", "kset", lambda k: _NanMv()),
    ("_seg_wide_start", "opts", lambda o: o.replace(finish_mode="ipm")),
    ("_seg_wide_cross", "opts", lambda o: o.replace(crossover_refine=0)),
    ("_seg_tier_restart", "opts", lambda o: o.replace(reg_eps=1e-3)),
    ("_seg_package", "keys", lambda k: k[:2]),
    ("_seg_narrow_prologue", "opts", lambda o: o.replace(scale=not o.scale)),
    ("_seg_finish_prologue", "opts", lambda o: o.replace(scale=not o.scale)),
    ("_seg_start", "opts", lambda o: o.replace(scale=not o.scale)),
    ("_seg_end", "opts", lambda o: o.replace(tol=1.0)),
]


@pytest.fixture(scope="module")
def segment_calls():
    return _solves()


@pytest.mark.parametrize("name,param,change", KEY_CASES, ids=[c[0] for c in KEY_CASES])
def test_key_without_a_parameter_replays_the_wrong_variant(monkeypatch, graphs, segment_calls,
                                                           name, param, change):
    """A segment called with a parameter changed, on one cache: with its
    full key, bitwise its eager result; with that parameter left out of
    the key, the replay runs the first variant's launches and the bits
    differ.  The params that are not pure data (the kernel sets, the
    options, the dtypes, the keys) all change the launches."""
    fn, state, data, params = segment_calls[name]
    second = {**params, param: change(params[param])}
    with port_hsd._full_precision_matmuls():
        eager = fn(state, data, **second)
        assert _differs(eager, fn(state, data, **params))  # the parameter matters

        def call(ps, drop=None):
            key = (name,) + tuple(sorted((k, v) for k, v in ps.items() if k != drop))
            return _loop._segment(functools.partial(fn, **ps), state, data, key)

        call(params)
        _assert_same(call(second), eager)
        monkeypatch.setattr(_loop, "_GRAPHS", collections.OrderedDict())
        monkeypatch.setattr(_loop, "_STATIC", {})
        call(params, drop=param)
        assert _differs(call(second, drop=param), eager)
    assert graphs["replays"] == 1


# the scan stages' segments whose keys test_torch_stages.py holds
STAGE_SEGMENTS = {"_seg_finish_start", "_seg_package_bucketed", "_seg_chunk_start", "_seg_concat",
                  "_seg_resume_gather", "_seg_scatter"}


def test_every_new_segment_has_a_key_case(segment_calls):
    """Each segment with parameters that ``hsd_solve_batched``, the scan
    stages' prologues and ``dense_path`` run has its case in ``KEY_CASES``
    (the no-cap scan's carry and concatenation take none)."""
    assert set(segment_calls) - STAGE_SEGMENTS == {c[0] for c in KEY_CASES}


# ---------------------------------------------------------------------------
# prepare reads nothing back
# ---------------------------------------------------------------------------

# the operators that move a value to the host or size a tensor by its data
HOST_READS = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique2",
              "item")


class _NoHostReads(TorchDispatchMode):
    """Raises on an operator that reads a value back to the host: one of
    ``HOST_READS``, or indexing by a boolean mask (its lanes counted on
    the host)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        masked = name.startswith("index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if name in HOST_READS or masked:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_reads(monkeypatch):
    def tolist(self):
        raise AssertionError("host read: tolist")

    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    return _NoHostReads


@pytest.mark.parametrize("read", ["item", "bool", "mask", "nonzero", "tolist"])
def test_the_guard_catches_a_host_read(no_host_reads, read):
    x = torch.arange(4.0)
    reads = {"item": lambda: x.sum().item(), "bool": lambda: bool(x.sum() > 0),
             "mask": lambda: x[x > 1], "nonzero": lambda: x.nonzero(), "tolist": x.tolist}
    with pytest.raises(AssertionError, match="host read"), no_host_reads():
        reads[read]()


SETS = {"reference": REFERENCE_KERNELS, "batchlast": BATCHLAST_KERNELS,
        "batchlast_fused": BATCHLAST_FUSED_KERNELS, "df64": df64.DF64_FINISH_KERNELS,
        "df64_f64form": df64.DF64_F64FORM_KERNELS, "df64_fastform": df64.DF64_FASTFORM_KERNELS,
        "mixed1": mixed.MIXED_IR1_KERNELS}


@pytest.mark.parametrize("per_instance", [False, True], ids=["shared_A", "per_instance"])
@pytest.mark.parametrize("name", list(SETS))
def test_prepare_reads_nothing_back(no_host_reads, name, per_instance):
    """Each kernel set's ``prepare`` (the reference, batch-last and fused,
    FP64/Ozaki in its three formations, mixed) on shared and per-instance
    A, in the dtype its path gives it, reads nothing back to the host."""
    A, _, _ = _problem(seed=7, nlp=4, per_instance=per_instance)
    dtype = torch.float64 if name.startswith(("df64", "mixed")) else torch.float32
    A = torch.from_numpy(A).to(dtype)
    with no_host_reads():
        ctx = SETS[name].prepare(A)
    assert ctx.A.shape == A.shape
