"""The one generator of the benchmark's traffic: from a configuration file
(the problem family and its sizes) and a traffic file (how the LPs are
grouped into calls), both plain data, and the run's seed, it makes every
input of a run on the host.

A *group* is a set of LPs that share one constraint matrix, in the
equality form the program solves: ``min cᵀx, Ax = b, x ≥ 0`` with ``A``
(m, n) and ``b`` (N, m), ``c`` (N, n).  The reference solves an LP from its
group, whatever call carried it.  A *batch* is what one call of the entry
gets: one group as it is (``layout: groups``), or every group padded into
one batch of per-instance matrices (``layout: padded``).

Problem kinds (the configuration's ``problem.kind``):

* ``dense_vanderbei``: a pool of ``groups × lps_per_group`` random LPs
  of ``m × n`` in Vanderbei form over one A, made from the configuration's
  ``pool_seed``, turned into the ``m × (n + m)`` equality form, put in
  the order the run's seed draws and split into ``groups`` consecutive
  groups.  Every seed gets the same LPs, so the same work, in another
  order: a pool made from the run's seed would change the work with the
  seed (a few hard lanes more or less move a sweep's wall by 10%).
* ``netlib_standins``: one group per fixture, in bucket order (smallest
  padded size first), of ``lps_per_group`` replicas whose b is scaled per
  replica by ``1 + b_scale · U(0, 1)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from lpbench.inputs import generate

__all__ = ["Group", "Batch", "Workload", "make"]


@dataclass
class Group:
    name: str
    A: np.ndarray  # (m, n) float32, equality form
    b: np.ndarray  # (N, m) float32
    c: np.ndarray  # (N, n) float32


@dataclass
class Batch:
    """One call's inputs: ``A`` (m, n) shared or (B, m, n); ``b``, ``c``;
    ``lanes``: [(group index, first lane in the group, count)], in order."""
    name: str
    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    lanes: list = field(default_factory=list)

    @property
    def size(self) -> int:
        return int(self.b.shape[0])


@dataclass
class Workload:
    groups: list
    batches: list


def _dense(problem: dict, traffic: dict, seed: int) -> list:
    """The pool of ``groups × lps_per_group`` LPs made from the
    configuration's ``pool_seed``, in the order the run's seed draws."""
    n_groups, per = int(traffic["groups"]), int(traffic["lps_per_group"])
    dtype = np.dtype(problem["dtype"])
    A, b, c = generate.random_standard_lp(int(problem["m"]), int(problem["n"]),
                                          nlp=n_groups * per, seed=int(problem["pool_seed"]),
                                          dtype=dtype)
    A_eq, b_eq, c_eq = generate.equality_form(A, b, c)
    order = np.random.default_rng(seed).permutation(n_groups * per)
    b_eq, c_eq = np.asarray(b_eq, dtype)[order], np.asarray(c_eq, dtype)[order]
    A_eq = np.asarray(A_eq, dtype)
    return [Group(f"batch{g}", A_eq, b_eq[g * per:(g + 1) * per], c_eq[g * per:(g + 1) * per])
            for g in range(n_groups)]


def _netlib_std(problem: dict) -> tuple:
    """The fixtures' names and standard forms (float64), in bucket order."""
    names = sorted(problem["fixtures"])
    stds = [generate.netlib_fixture(nm, *problem["fixtures"][nm]) for nm in names]
    order = []
    for _, idxs in sorted(generate.bucket_problems([s[0].shape for s in stds]).items()):
        if len(idxs) != 1:
            raise ValueError(f"a bucket holds {len(idxs)} fixtures; each needs its own")
        order.append(idxs[0])
    return [names[i] for i in order], [stds[i] for i in order]


def _netlib(problem: dict, traffic: dict, seed: int) -> tuple:
    per = int(traffic["lps_per_group"])
    dtype = np.dtype(problem["dtype"])
    rng = np.random.default_rng(seed)
    names, stds = _netlib_std(problem)
    groups, scales = [], []
    for nm, (A, b, c) in zip(names, stds):
        A_eq, b_eq, c_eq = generate.equality_form(A, b, c)
        scale = (1.0 + problem["b_scale"] * rng.random((per, 1))).astype(dtype)
        groups.append(Group(nm, np.asarray(A_eq, dtype),
                            np.asarray(b_eq, dtype).reshape(1, -1) * scale,
                            np.ascontiguousarray(np.broadcast_to(
                                np.asarray(c_eq, dtype).reshape(1, -1), (per, c_eq.shape[-1])))))
        scales.append(scale[:, 0])
    return groups, stds, scales


def _padded(stds: list, scales: list, dtype) -> Batch:
    """Every fixture's replicas in one batch of per-instance matrices: the
    standard forms padded to a common size, then turned into the equality
    form, replica after replica in group order."""
    A_pad, b_pad, c_pad, _, _ = generate.pad_and_mask(stds, dtype)
    k, mp = A_pad.shape[0], A_pad.shape[1]
    eye = np.broadcast_to(np.eye(mp, dtype=dtype), (k, mp, mp))
    A_eq = np.concatenate([A_pad, eye], axis=2)
    c_eq = np.concatenate([-c_pad, np.zeros((k, mp), dtype)], axis=1)
    per = len(scales[0])
    lane_of = np.repeat(np.arange(k), per)
    A3 = np.ascontiguousarray(A_eq[lane_of])
    b3 = b_pad[lane_of].copy()
    for g, ((A, _, _), scale) in enumerate(zip(stds, scales)):
        b3[g * per:(g + 1) * per, :A.shape[0]] *= scale[:, None]
    c3 = np.ascontiguousarray(c_eq[lane_of])
    return Batch("padded", A3, b3, c3, [(g, 0, per) for g in range(k)])


def make(config: dict, traffic: dict, seed: int) -> Workload:
    """Every input of a run of ``config`` under ``traffic`` from ``seed``."""
    problem = config["problem"]
    kind = problem["kind"]
    stds = scales = None
    if kind == "dense_vanderbei":
        groups = _dense(problem, traffic, seed)
    elif kind == "netlib_standins":
        groups, stds, scales = _netlib(problem, traffic, seed)
    else:
        raise ValueError(f"unknown problem kind {kind!r}")
    layout = traffic.get("layout", "groups")
    if layout == "groups":
        batches = [Batch(g.name, g.A, g.b, g.c, [(i, 0, g.b.shape[0])])
                   for i, g in enumerate(groups)]
    elif layout == "padded" and stds is not None:
        batches = [_padded(stds, scales, np.dtype(problem["dtype"]))]
    else:
        raise ValueError(f"layout {layout!r} does not apply to problem kind {kind!r}")
    return Workload(groups, batches)
