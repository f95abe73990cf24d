"""The port's ``lax.while_loop``: blocks of gated iterations.

* ``_run_phase`` on the gated route (``_loop._device_while``, eager on the
  CPU: the code the card captures into a CUDA graph) against the
  per-iteration host loop (``hsd._HOST_LOOP``), BITWISE on every
  ``HSDState`` field, at block lengths 1 to 5, in an f32 narrow phase with
  STALLED and NUMERICAL lanes on the batch-last set, at a ``maxiter`` no
  block length but 1 divides, with ``maxiter <= k`` at entry, with no lane
  RUNNING at entry, with a tensor budget ``k + finish_cap``, and through
  ``_run_narrow_phase``'s ``kkt_warmup`` split;
* the counters: ``HOST_STEPS`` is the change in ``k``, ``HOST_SYNCS`` the
  number of blocks (one predicate read an iteration on the host loop),
  ``GATED_OFF_STEPS`` the rest of the blocks' iterations;
* the same inputs in f64 through the reference's ``_run_phase``
  (``lax.while_loop``), int and traced budgets: statuses, iterations and
  ``k`` equal, iterates to 1e-10 mid-trajectory;
* the two routes that keep the host loop, ``log_every`` and a collective
  ``reduce_any``: one predicate read an iteration;
* the block length by A's layout: per-instance A runs blocks of
  ``BLOCK_PER_INSTANCE`` whatever ``BLOCK`` is, bitwise the host loop;
* the graphs' static buffers: one set a spec, shared by the graphs over
  it and dropped with the last of them, the data copied in only when it
  changed, the caller's tensors never kept alive.
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
from pycllp_tpu.io.generate import random_equality_lp
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import _loop
from pycllp_tpu_torch.solvers import hsd as port_hsd
from pycllp_tpu_torch.solvers.options import SolverOptions, Status

BLOCKS = (1, 2, 3, 4, 5)
RUNNING, OPTIMAL = int(Status.RUNNING), int(Status.OPTIMAL)
STALLED, NUMERICAL = int(Status.STALLED), int(Status.NUMERICAL)
# bench.py's BENCH_FINISH=0 operating point, at a tolerance the f32 floor
# stalls some lanes short of
NARROW = SolverOptions(dtype="float32", tol=1e-6, maxiter=40, stall_patience=3, stall_rtol=0.05,
                       refine_steps=0, kkt_refine=3, kkt_refine_pred=0, init_point="mehrotra")
F64 = SolverOptions(tol=1e-8, init_point="mehrotra", kkt_refine=1)


def _narrow_problem(per_instance=False):
    """f32 data on the batch-last set; lane 5's b holds a NaN (→ NUMERICAL).
    ``per_instance``: A as (B, m, n), a copy a lane."""
    A, b, c = random_equality_lp(8, 20, nlp=24, seed=3)
    if per_instance:
        A = np.ascontiguousarray(np.broadcast_to(A, (b.shape[0],) + A.shape))
    A, b, c = (torch.from_numpy(v.astype(np.float32)) for v in (A, b, c))
    b[5, 2] = float("nan")
    ctx = BATCHLAST_KERNELS.prepare(A)
    state = port_hsd._fresh_state(ctx, b, c, NARROW, BATCHLAST_KERNELS, torch.float32)
    return ctx, b, c, state


def _f64_problem():
    A, b, c = random_equality_lp(10, 22, nlp=16, seed=21)
    ctx = REFERENCE_KERNELS.prepare(torch.from_numpy(A))
    b, c = torch.from_numpy(b), torch.from_numpy(c)
    return (A, b.numpy(), c.numpy()), ctx, b, c


def _phase(monkeypatch, block, *args, narrow=False):
    """One phase on the gated route at ``block`` (``block=None``: the host
    loop), with the counters it moved."""
    monkeypatch.setattr(port_hsd, "_HOST_LOOP", block is None)
    monkeypatch.setattr(_loop, "BLOCK", block or 1)
    monkeypatch.setattr(port_hsd, "HOST_STEPS", 0)
    monkeypatch.setattr(_loop, "HOST_SYNCS", 0)
    monkeypatch.setattr(_loop, "GATED_OFF_STEPS", 0)
    run = port_hsd._run_narrow_phase if narrow else port_hsd._run_phase
    out = run(*args)
    return out, {"steps": port_hsd.HOST_STEPS, "syncs": _loop.HOST_SYNCS,
                 "gated_off": _loop.GATED_OFF_STEPS}


def _bits(t: torch.Tensor) -> bytes:
    return np.ascontiguousarray(t.numpy()).tobytes()


def _assert_bitwise(out, ref):
    for name, a, r in zip(port_hsd.HSDState._fields, out, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _bits(a) == _bits(r), f"{name} differs"


def _case(name, per_instance=False):
    """(args of _run_phase or _run_narrow_phase, narrow?) of a named case."""
    ctx, b, c, state = _narrow_problem(per_instance)
    ks, dt = BATCHLAST_KERNELS, torch.float32
    if name == "narrow":  # to the end: OPTIMAL, STALLED and NUMERICAL lanes
        return (ctx, b, c, state, NARROW, ks, dt, NARROW.tol, 40), False
    if name == "ragged":  # 7 iterations with lanes RUNNING: only block 1 divides 7
        return (ctx, b, c, state, NARROW.replace(tol=1e-9), ks, dt, 1e-9, 7), False
    mid = port_hsd._run_phase(ctx, b, c, state, NARROW, ks, dt, 1e-9, 4)
    if name == "spent":  # maxiter <= k at entry
        return (ctx, b, c, mid, NARROW, ks, dt, 1e-9, 3), False
    if name == "none_running":
        done = mid._replace(status=torch.where(mid.status == RUNNING, OPTIMAL, mid.status))
        return (ctx, b, c, done, NARROW, ks, dt, 1e-9, 40), False
    if name == "tensor_budget":  # tier 1's budget, k + finish_cap, a device scalar
        return (ctx, b, c, mid, NARROW, ks, dt, 1e-9, mid.k + 3), False
    assert name == "kkt_warmup"  # two loops: kkt_refine=0 to k = 2, then refined
    opts = NARROW.replace(kkt_warmup=2)
    return (ctx, b, c, state, opts, ks, dt, opts.tol, 40), True


CASES = ("narrow", "ragged", "spent", "none_running", "tensor_budget", "kkt_warmup")


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", CASES)
def test_gated_block_is_the_host_loop_bitwise(monkeypatch, case, block):
    args, narrow = _case(case)
    ref, ref_counts = _phase(monkeypatch, None, *args, narrow=narrow)
    out, counts = _phase(monkeypatch, block, *args, narrow=narrow)
    _assert_bitwise(out, ref)
    # k is a device scalar on both routes
    assert out.k.dim() == 0 and out.k.dtype == torch.int32
    n = int(out.k) - int(args[3].k)
    assert counts["steps"] == ref_counts["steps"] == n
    if narrow:
        return  # two loops: the syncs are checked per loop by the other cases
    # the host loop reads the predicate before every iteration, and once more
    # when the lanes (not the budget) end it
    assert n <= ref_counts["syncs"] <= n + 1
    assert counts["syncs"] == max(1, -(-n // block))
    assert counts["gated_off"] == counts["syncs"] * block - n
    if case == "narrow":
        st = ref.status.numpy()
        assert {OPTIMAL, STALLED, NUMERICAL} <= set(st.tolist()) and RUNNING not in st
    if case == "ragged":
        assert n == 7 and (ref.status.numpy() == RUNNING).any()
    if case in ("spent", "none_running"):
        assert n == 0 and counts["gated_off"] == block
        _assert_bitwise(out, args[3])


def test_kkt_warmup_split_runs_two_loops(monkeypatch):
    """With ``kkt_warmup`` the narrow phase is two gated loops: the first to
    k = 2 without KKT sweeps, the second refined to the end."""
    args, _ = _case("kkt_warmup")
    out, counts = _phase(monkeypatch, 2, *args, narrow=True)
    n = int(out.k)
    assert n > 2 and counts["steps"] == n
    assert counts["syncs"] == 1 + max(1, -(-(n - 2) // 2))


def _reference_phase(data, maxiter, traced: bool):
    A, b, c = data
    ref_opts = ref_pkg.SolverOptions(**dataclasses.asdict(F64))
    ctx = REF_KS.prepare(jnp.asarray(A))
    bj, cj = jnp.asarray(b), jnp.asarray(c)
    state = ref_hsd._fresh_state(ctx, bj, cj, ref_opts, REF_KS, jnp.float64)
    state = ref_hsd._run_phase(ctx, bj, cj, state, ref_opts, REF_KS, jnp.float64, F64.tol, 1,
                               jnp.any)
    limit = state.k + maxiter if traced else maxiter
    state = ref_hsd._run_phase(ctx, bj, cj, state, ref_opts, REF_KS, jnp.float64, F64.tol, limit,
                               jnp.any)
    return {f: np.asarray(v) for f, v in state._asdict().items()}


@pytest.mark.parametrize("budget", ["int", "tensor"])
def test_gated_phase_matches_jax_while_loop(monkeypatch, budget):
    """The same f64 inputs through the reference's ``lax.while_loop`` phase
    and the port's gated block (block 2): one iteration, then a phase of
    budget 4 (absolute) or ``k + 3`` (a device scalar / a traced value),
    the second block's last iteration gated off."""
    data, ctx, b, c = _f64_problem()
    ref = _reference_phase(data, 4 if budget == "int" else 3, traced=budget == "tensor")
    state = port_hsd._fresh_state(ctx, b, c, F64, REFERENCE_KERNELS, torch.float64)
    state = port_hsd._run_phase(ctx, b, c, state, F64, REFERENCE_KERNELS, torch.float64, F64.tol, 1)
    limit = 4 if budget == "int" else state.k + 3
    out, counts = _phase(monkeypatch, 2, ctx, b, c, state, F64, REFERENCE_KERNELS, torch.float64,
                         F64.tol, limit)
    port = interop.state_to_numpy(out)
    assert port["k"] == ref["k"] == 4 and counts["steps"] == 3 and counts["syncs"] == 2
    assert counts["gated_off"] == 1
    for name in ("status", "iterations", "best_k"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    for name in ("x", "y", "z", "tau", "kappa", "best_x", "best_score"):
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-10, atol=1e-12, err_msg=name)


def test_state_carries_k_as_a_device_scalar():
    """``interop`` moves ``k`` as a 0-d int32 tensor, both ways."""
    _, ctx, b, c = _f64_problem()
    state = port_hsd._fresh_state(ctx, b, c, F64, REFERENCE_KERNELS, torch.float64)
    assert state.k.dim() == 0 and state.k.dtype == torch.int32 and int(state.k) == 0
    fields = interop.state_to_numpy(state._replace(k=state.k + 9))
    assert fields["k"].dtype == np.int32 and fields["k"] == 9
    back = interop.state_from_numpy(fields, device="cpu")
    assert back.k.dim() == 0 and back.k.dtype == torch.int32 and int(back.k) == 9


def test_log_every_keeps_the_host_loop(monkeypatch):
    """``log_every`` reads its records every iteration: the host loop, one
    record an iteration, no block, the gated route's answer."""
    records = []
    monkeypatch.setattr(port_hsd, "iteration_record", lambda *a: records.append(a))
    args, _ = _case("narrow")
    ref, _ = _phase(monkeypatch, 2, *args)
    logged = list(args)
    logged[4] = NARROW.replace(log_every=1)
    out, counts = _phase(monkeypatch, 2, *logged)
    assert len(records) == counts["steps"] == int(out.k) > 0
    assert counts["syncs"] == counts["steps"] + 1  # every iteration's predicate, and the last
    _assert_bitwise(out, ref)


def test_collective_reduce_any_keeps_the_host_loop(monkeypatch):
    """A ``reduce_any`` that is neither None nor ``torch.any`` (the sharded
    solve's collective) is called once an iteration, plus the test that
    ends the loop; the gated route's answer."""
    calls = []

    def reduce_any(mask):
        calls.append(mask.shape[0])
        return bool(mask.any())

    args, _ = _case("narrow")
    ref, _ = _phase(monkeypatch, 2, *args)
    out, counts = _phase(monkeypatch, 2, *args, reduce_any)
    assert len(calls) == counts["syncs"] == counts["steps"] + 1 == int(out.k) + 1
    _assert_bitwise(out, ref)
    local, local_counts = _phase(monkeypatch, 2, *args, torch.any)
    # torch.any reduces locally: the gated route, one read a block
    assert local_counts["syncs"] == -(-local_counts["steps"] // 2)
    _assert_bitwise(local, ref)


def test_loop_helpers_map_trees():
    """The static-buffer helpers keep a tree's structure and describe its
    tensors by shape, dtype and strides (the graph cache's key)."""
    ctx = BATCHLAST_KERNELS.prepare(torch.ones((3, 5)))
    tree = (ctx, torch.zeros(4), None)
    assert len(_loop._flatten(tree)) == 4  # A, Asq, W (Wp is None) and the vector
    clone = _loop._map(torch.clone, tree)
    assert type(clone[0]) is type(ctx) and clone[0].Wp is None and clone[2] is None
    assert _loop._spec(clone) == _loop._spec(tree)
    assert _loop._spec((torch.zeros(4, 2).T,)) != _loop._spec((torch.zeros(2, 4),))


@pytest.mark.parametrize("per_instance", [1, 3])
@pytest.mark.parametrize("case", ["narrow", "ragged"])
def test_per_instance_a_runs_its_own_block(monkeypatch, case, per_instance):
    """On per-instance A the block is ``BLOCK_PER_INSTANCE`` (here 1 or 3),
    not ``BLOCK`` (here 4): one read a block of it, bitwise the host loop."""
    args, _ = _case(case, per_instance=True)
    assert args[0].A.dim() == 3
    ref, ref_counts = _phase(monkeypatch, None, *args)
    monkeypatch.setattr(_loop, "BLOCK_PER_INSTANCE", per_instance)
    out, counts = _phase(monkeypatch, 4, *args)
    _assert_bitwise(out, ref)
    n = int(out.k)
    assert counts["steps"] == ref_counts["steps"] == n > 0
    assert counts["syncs"] == -(-n // per_instance)
    assert counts["gated_off"] == counts["syncs"] * per_instance - n
    if per_instance == 1:
        assert counts["gated_off"] == 0


def test_static_buffers_copy_what_changed_and_hold_no_tensor():
    """The data is copied in when the tensors differ or were modified since
    the last copy, skipped otherwise; the state (``always``) every time;
    the buffers keep no caller's tensor alive."""
    a, v = torch.arange(6.0).reshape(2, 3), torch.ones(4)
    st = _loop._Static((a, v))
    buf_a, buf_v = st.tree
    assert buf_a.data_ptr() != a.data_ptr() and buf_a.stride() == a.stride()
    st.load((a, v), always=False)
    assert torch.equal(buf_a, a) and torch.equal(buf_v, v)
    buf_v.fill_(-1.0)  # a marker: a skipped load leaves it
    st.load((a, v), always=False)
    assert (buf_v == -1.0).all()
    v.add_(1.0)  # modified in place: copied again
    st.load((a, v), always=False)
    assert torch.equal(buf_v, v)
    st.load((a, v.clone()), always=False)  # another tensor, the same values
    buf_v.fill_(-1.0)
    st.load((a, v), always=True)
    assert torch.equal(buf_v, v)
    ref = weakref.ref(a)
    del a
    gc.collect()
    assert ref() is None


def test_graphs_share_static_buffers_by_spec(monkeypatch):
    """Graphs over one state spec share its buffers, and over one data spec
    the data's, whatever their keys; evicting the last graph over a spec
    drops its buffers."""
    monkeypatch.setattr(_loop, "_GRAPHS", collections.OrderedDict())
    monkeypatch.setattr(_loop, "_STATIC", {})
    monkeypatch.setattr(_loop, "GRAPH_CACHE_SIZE", 2)
    ctx, b, c, state = _narrow_problem()
    limit = torch.full((), 5, dtype=torch.int32)

    def graph(key, st, data):
        g = _loop._Graph(port_hsd._phase_cond, lambda d: None, st, data, limit, 2)
        _loop._GRAPHS[key] = g
        _loop._evict()
        return g

    g1 = graph("a", state, (ctx, b, c))
    g2 = graph("b", state, (ctx, b, c))
    assert g1._state is g2._state and g1._data is g2._data and len(_loop._STATIC) == 2
    g3 = graph("c", state, (ctx, b[:12], c[:12]))  # new data spec; evicts "a"
    assert g3._state is g1._state and g3._data is not g1._data and len(_loop._STATIC) == 3
    graph("d", state._replace(k=state.k[None]), (ctx, b[:12], c[:12]))  # evicts "b"
    assert list(_loop._GRAPHS) == ["c", "d"] and len(_loop._STATIC) == 3
    assert g1.data_key not in _loop._STATIC
