"""The port's jitted scan stages: straight-line segments as replayed graphs.

* ``_loop._segment`` on the CPU runs ``fn`` eagerly on the caller's
  tensors, bitwise, and keeps nothing;
* the graph route, emulated on the CPU: every segment goes through
  ``_loop._Segment``'s static buffers, cached by its key, and a "replay"
  runs the cached entry's ``run`` (what the card captures) — only the CUDA
  graph itself is left out.  Its buffers hold no caller's tensor and copy
  in only what changed; its outputs are copies;
* the key names every parameter that decides a segment's launches: the
  width, the tier, ``reopen`` and the truncation point;
* ``_hsd_scan_finish_core`` on the emulated graph route, both finish
  modes and every ``truncate``, bitwise the eager-segment route
  (``hsd._EAGER_SEGMENTS``), on one graph cache across variants (a key
  that missed a parameter would replay another variant's launches), and
  the narrow core with ``warm_chain`` likewise;
* a solve whose rejects overflow ``finish_bucket`` (tier 1 runs several
  rounds, tier 2 its restart) against the JAX reference's
  ``_hsd_scan_finish_core`` on the reference sets, from one narrow state,
  at ``test_torch_finish.py``'s tolerance.
"""

import collections
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycllp_tpu as ref_pkg
import pycllp_tpu_torch as port_pkg
from pycllp_tpu.io.generate import random_standard_lp
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import _loop
from pycllp_tpu_torch.solvers import hsd as port_hsd

OPTIMAL = int(port_pkg.Status.OPTIMAL)
STALLED = int(port_pkg.Status.STALLED)
NUMERICAL = int(port_pkg.Status.NUMERICAL)
CPU = torch.device("cpu")
# bench.py's bench_options() at its defaults (BENCH_FINISH=1)
BENCH_OPTIONS = dict(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="crossover", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)
# a narrow stage cut to 3 iterations (cap 2) leaves rejects for every tier:
# at finish_bucket 4, tier 1 runs all 8 rounds and tier 2 one, with its restart
NARROW_MAXITER, CAP, BUCKET, ROUNDS, FINISH_CAP = 3, 2, 16, 8, 3


def _problem(seed=1, nlp=64, m=16):
    lp = random_standard_lp(m, m, nlp=nlp, seed=seed, dtype=np.float32)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    b3 = torch.from_numpy(b).reshape(2, nlp // 2, -1)
    c3 = torch.from_numpy(c).reshape(2, nlp // 2, -1)
    return A, b3, c3


def _opts(mode="crossover"):
    return port_pkg.SolverOptions(**BENCH_OPTIONS).replace(finish_mode=mode)


def _narrow(A, b3, c3, opts, kset=BATCHLAST_KERNELS, keys=None, warm_chain=False):
    view = port_hsd._narrow_opts_view(opts.replace(maxiter=NARROW_MAXITER), opts.switch_tol)
    with port_hsd._full_precision_matmuls():
        return port_hsd._hsd_scan_narrow_core(A, b3, c3, view, kset, keys, CAP, BUCKET, CPU,
                                              warm_chain)


def _finish(A, b3, c3, sflat, opts, kset=BATCHLAST_KERNELS, bucket=4, truncate=None,
            keys=("x", "objective", "status", "iterations")):
    with port_hsd._full_precision_matmuls():
        return port_hsd._hsd_scan_finish_core(
            A, b3, c3, sflat, port_hsd._finish_opts_view(opts), kset, keys, FINISH_CAP,
            bucket, CPU, rounds=ROUNDS, truncate=truncate)


def _bits(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.numpy()).tobytes()


def _assert_same(out, ref):
    """The same tree (structure, shapes, dtypes) holding the same bits."""
    assert type(out) is type(ref)
    if isinstance(ref, torch.Tensor):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert _bits(out) == _bits(ref)
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


@pytest.fixture
def graphs(monkeypatch):
    """The graph route on the CPU: segments through ``_Segment``'s static
    buffers and the graph cache, a replay running the cached entry's
    ``run``.  Yields the captures and replays it counted."""
    monkeypatch.setattr(_loop, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setattr(_loop, "_STATIC", {})
    monkeypatch.setattr(_loop, "_captures", lambda tree: True)
    counts = collections.Counter()

    def warm_up(self, device):
        self.keep(self.call())

    def capture(self, device):
        counts["captures"] += 1

    def replay(self):
        counts["replays"] += 1
        self.run()

    monkeypatch.setattr(_loop._Segment, "warm_up", warm_up)
    monkeypatch.setattr(_loop._Segment, "capture", capture)
    monkeypatch.setattr(_loop._Segment, "replay", replay)
    return counts


def _tree_fn(state, data):
    (x, pair), (w,) = state, data
    return {"sum": x + w, "pair": (pair[0] * 2.0, pair[1]), "w": w}


def test_segment_runs_fn_eagerly_on_the_cpu(monkeypatch):
    """On the CPU (and with ``eager``) a segment is ``fn`` itself on the
    caller's tensors: the very objects it returns, nothing cached."""
    monkeypatch.setattr(_loop, "SEGMENT_CALLS", 0)
    x, p, w = torch.arange(4.0), (torch.ones(3), torch.zeros(2, dtype=torch.int32)), torch.ones(4)
    ref = _tree_fn((x, p), (w,))
    for eager in (False, True):
        out = _loop._segment(_tree_fn, (x, p), (w,), ("t",), eager=eager)
        assert out["w"] is w and out["pair"][1] is p[1]
        assert _bits(out["sum"]) == _bits(ref["sum"]) and _bits(out["pair"][0]) == _bits(ref["pair"][0])
    assert _loop.SEGMENT_CALLS == 2 and not _loop._GRAPHS


def test_segment_buffers_copy_what_changed_and_hold_no_tensor(graphs):
    """On the graph route the inputs are copied into buffers of their own,
    skipped when they are the very tensors, unmodified, copied last; the
    output is a copy of the output buffers; no caller's tensor is kept."""
    x, p, w = torch.arange(4.0), (torch.ones(3), torch.zeros(2, dtype=torch.int32)), torch.ones(4)
    out = _loop._segment(_tree_fn, (x, p), (w,), ("t",))
    (entry,) = _loop._GRAPHS.values()
    buf_x = entry._ins[0][1].tree
    buf_w = entry._data.tree[0]
    assert buf_x.data_ptr() != x.data_ptr() and buf_w.data_ptr() != w.data_ptr()
    assert out["w"].data_ptr() not in (w.data_ptr(), buf_w.data_ptr())
    assert out["sum"].data_ptr() != entry._out.tree["sum"].data_ptr()
    _assert_same(out, _tree_fn((x, p), (w,)))
    assert graphs == {"captures": 1}
    buf_x.fill_(-1.0)  # a marker: a skipped load leaves it
    again = _loop._segment(_tree_fn, (x, p), (w,), ("t",))
    assert (again["sum"] == -1.0 + w).all() and graphs["replays"] == 1
    x.add_(1.0)  # modified in place: copied again
    again = _loop._segment(_tree_fn, (x, p), (w,), ("t",))
    _assert_same(again, _tree_fn((x, p), (w,)))
    # the same spec, other tensors: copied, one entry
    y = torch.full((4,), 7.0)
    _assert_same(_loop._segment(_tree_fn, (y, p), (w,), ("t",)), _tree_fn((y, p), (w,)))
    assert len(_loop._GRAPHS) == 1 and graphs["captures"] == 1
    refs = [weakref.ref(t) for t in (x, y, w)]
    del x, y, w, out, again
    gc.collect()
    assert all(r() is None for r in refs)


def _keys(monkeypatch, run):
    """The keys of the segments ``run`` called, in order."""
    keys = []
    inner = _loop._segment

    def recorded(fn, state, data, key, eager=False, borrow=False):
        keys.append(key)
        return inner(fn, state, data, key, eager, borrow)

    monkeypatch.setattr(_loop, "_segment", recorded)
    run()
    monkeypatch.setattr(_loop, "_segment", inner)
    return keys


def _of(keys, name):
    return [dict(k[1:]) for k in keys if k[0] == name]


def test_segment_key_names_width_tier_reopen_and_truncate(monkeypatch):
    A, b3, c3 = _problem()
    opts = _opts()
    sflat = _narrow(A, b3, c3, opts)
    keys = _keys(monkeypatch, lambda: _finish(A, b3, c3, sflat, opts))
    gathers = _of(keys, "_seg_tier_gather")
    # tier 1 (width finish_bucket, budget finish_cap) and tier 2 (width 256,
    # budget finish_maxiter) gather under their own keys
    assert {(g["width"], g["budget"]) for g in gathers} == {(4, FINISH_CAP), (256, 20)}
    # tier 1's scatter re-opens its rejects, tier 2's (the rescue) does not
    assert {s["reopen"] for s in _of(keys, "_seg_tier_scatter")} == {True, False}
    (tier0,) = {tuple(sorted(r.items())) for r in _of(keys, "_seg_tier0_round")}
    assert dict(tier0)["width"] == b3.shape[0] * b3.shape[1]  # min(max(16384, 8 * bucket), N)
    wider = _keys(monkeypatch, lambda: _finish(A, b3, c3, sflat, opts, bucket=8))
    assert {g["width"] for g in _of(wider, "_seg_tier_gather")} - {256} == {8}
    assert {p["bucket"] for p in _of(wider, "_seg_package_bucketed")} == {8}
    # truncated before stage 3: the prologue and the finish's start alone,
    # not re-opened
    pre = _keys(monkeypatch, lambda: _finish(A, b3, c3, sflat, opts, truncate="pre"))
    assert [k[0] for k in pre] == ["_seg_finish_prologue", "_seg_finish_start",
                                   "_seg_package_bucketed"]
    assert _of(pre, "_seg_finish_start")[0]["reopen"] is False
    assert [k[0] for k in keys[:2]] == ["_seg_finish_prologue", "_seg_stage3_crossover"]
    ipm = _keys(monkeypatch, lambda: _finish(A, b3, c3, sflat, _opts("ipm")))
    assert _of(ipm, "_seg_finish_start")[0]["reopen"] is True
    assert {r["restart"] for r in _of(ipm, "_seg_resume_gather")} == {False, True}


def _eager(monkeypatch, run):
    monkeypatch.setattr(port_hsd, "_EAGER_SEGMENTS", True)
    try:
        return run()
    finally:
        monkeypatch.setattr(port_hsd, "_EAGER_SEGMENTS", False)


CASES = [("crossover", t) for t in (None, "pre", "stage3", "tier0", "tier1")] + \
        [("ipm", t) for t in (None, "pre", "stage3")]


@pytest.mark.parametrize("mode,truncate", CASES)
def test_finish_core_graph_route_is_the_eager_route_bitwise(monkeypatch, graphs, mode, truncate):
    """The finish on the emulated graph route, on one cache: the full finish,
    then the truncated one, then at another bucket, each bitwise the
    eager-segment route's; a second run of a variant captures nothing."""
    A, b3, c3 = _problem()
    opts = _opts(mode)
    sflat = _narrow(A, b3, c3, opts)
    # lanes the narrow stage ended: the ipm finish re-opens the STALLED ones
    status = sflat.status.clone()
    status[:6], status[6:8], status[8:10] = STALLED, NUMERICAL, OPTIMAL
    sflat = sflat._replace(status=status)
    variants = [dict(), dict(truncate=truncate), dict(truncate=truncate, bucket=8)]
    for kw in variants:
        cached = len(_loop._GRAPHS)
        ref = _eager(monkeypatch, lambda: _finish(A, b3, c3, sflat, opts, **kw))
        assert len(_loop._GRAPHS) == cached  # the eager route caches nothing
        for _ in range(2):
            before = graphs["captures"]
            _assert_same(_finish(A, b3, c3, sflat, opts, **kw), ref)
        assert graphs["captures"] == before  # the second run replays
    assert graphs["replays"] > 0
    # the wide state itself, where the finish returns it after stage 3 in
    # ipm mode: the rho keys route through _package
    rho = ("objective", "status", "rho_p")
    ref = _eager(monkeypatch, lambda: _finish(A, b3, c3, sflat, opts, keys=rho))
    _assert_same(_finish(A, b3, c3, sflat, opts, keys=rho), ref)


@pytest.mark.parametrize("keys", [None, ("x", "objective", "status", "iterations")])
def test_narrow_core_warm_chain_graph_route_is_the_eager_route_bitwise(monkeypatch, graphs, keys):
    """The narrow stage with ``warm_chain`` (chunk k+1 starts from chunk k's
    end, in the chunk's start segment) on the emulated graph route, twice:
    the flat state (``keys=None``) or the packaged outputs, bitwise."""
    A, b3, c3 = _problem(seed=4)
    opts = _opts().replace(finish_dtype=None) if keys else _opts()
    ref = _eager(monkeypatch, lambda: _narrow(A, b3, c3, opts, keys=keys, warm_chain=True))
    cold = _eager(monkeypatch, lambda: _narrow(A, b3, c3, opts, keys=keys))
    assert any(_bits(a) != _bits(b) for a, b in zip(
        ref.values() if keys else ref, cold.values() if keys else cold))  # the chain matters
    for _ in range(2):
        _assert_same(_narrow(A, b3, c3, opts, keys=keys, warm_chain=True), ref)
    _assert_same(_narrow(A, b3, c3, opts, keys=keys), cold)
    assert graphs["replays"] > 0


def test_overflowing_finish_matches_jax_reference(monkeypatch):
    """Rejects beyond ``finish_bucket``: tier 0 (width min(16384, N), one
    round at this size), tier 1 over several rounds of 4 lanes and tier 2
    with its restart, against the JAX reference's finish core on the
    reference sets, from the reference's own narrow state."""
    A, b3, c3 = _problem()
    ref_opts = ref_pkg.SolverOptions(**BENCH_OPTIONS)
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    narrow = ref_hsd._narrow_opts_view(ref_opts.replace(maxiter=NARROW_MAXITER), opts.switch_tol)
    jb3, jc3 = jnp.asarray(b3.numpy()), jnp.asarray(c3.numpy())
    sflat = ref_hsd._hsd_scan_narrow_core(jnp.asarray(A), jb3, jc3, narrow, REF_KS, None, CAP,
                                          BUCKET)
    fields = {f: np.asarray(v) for f, v in sflat._asdict().items()}
    keys = ("objective", "status")
    ref = ref_hsd._hsd_scan_finish_core(jnp.asarray(A), jb3, jc3, sflat,
                                        ref_hsd._finish_opts_view(ref_opts), REF_KS, keys,
                                        FINISH_CAP, 4, ROUNDS)
    ref = dict(zip(keys, ref))
    outs = []

    def run():
        with port_hsd._full_precision_matmuls():
            outs.append(port_hsd._hsd_scan_finish_core(
                A, b3, c3, interop.state_from_numpy(fields, device="cpu"),
                port_hsd._finish_opts_view(opts), REFERENCE_KERNELS, keys, FINISH_CAP, 4, CPU,
                rounds=ROUNDS))

    port_keys = _keys(monkeypatch, run)
    (port,) = outs
    names = collections.Counter(k[0] for k in port_keys)
    tier1 = [g for g in _of(port_keys, "_seg_tier_gather") if g["width"] == 4]
    assert names["_seg_tier0_round"] == 1 and len(tier1) >= 2 and names["_seg_tier_restart"]
    rs, ps = np.asarray(ref["status"]), port["status"].numpy()
    same = rs == ps
    assert same.mean() >= 0.98, (np.unique(rs, return_counts=True), np.unique(ps, return_counts=True))
    assert (ps == OPTIMAL).mean() >= 0.9
    np.testing.assert_allclose(port["objective"].numpy()[same], np.asarray(ref["objective"])[same],
                               rtol=1e-7, atol=1e-7)
