"""The benchmark's frozen generators give, bit for bit, what the program's
current ``io/`` and ``models/`` give at small sizes, and the traffic
generator makes the batches that the program's own benchmark script made."""

from __future__ import annotations

import numpy as np
import pytest

from lpbench import harness
from lpbench.inputs import generate, traffic
from pycllp_tpu_torch.io import netlib
from pycllp_tpu_torch.io.generate import random_standard_lp
from pycllp_tpu_torch.models import StandardLP


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nlp", [0, 1, 37])
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 17])
def test_random_standard_lp_bitwise(dtype, nlp, seed):
    ours = generate.random_standard_lp(9, 6, nlp=nlp, seed=seed, dtype=dtype)
    port = random_standard_lp(9, 6, nlp=nlp, seed=seed, dtype=dtype)
    assert all(_same(a, b) for a, b in zip(ours, (port.A, port.b, port.c)))


@pytest.mark.parametrize("nlp", [0, 4])
def test_equality_form_bitwise(nlp):
    A, b, c = generate.random_standard_lp(7, 5, nlp=nlp, seed=1, dtype=np.float32)
    eq = StandardLP(A=A, b=b, c=c).to_equality_form()
    assert all(_same(x, y) for x, y in zip(generate.equality_form(A, b, c), (eq.A, eq.b, eq.c)))


@pytest.mark.parametrize("name", sorted(netlib.NETLIB_SCALES))
def test_netlib_fixture_bitwise(name, monkeypatch):
    monkeypatch.delenv("PYCLLP_NETLIB_DIR", raising=False)
    std = netlib.load_fixture(name).lp.to_standard_form()[0]
    ours = generate.netlib_fixture(name, *netlib.NETLIB_SCALES[name])
    assert all(_same(a, b) for a, b in zip(ours, (std.A, std.b, std.c)))


def test_buckets_and_padding_bitwise():
    stds = [netlib.load_fixture(nm).lp.to_standard_form()[0] for nm in netlib.fixture_names()]
    ours = [generate.netlib_fixture(nm, *netlib.NETLIB_SCALES[nm]) for nm in netlib.fixture_names()]
    assert generate.bucket_problems([p[0].shape for p in ours]) == netlib.bucket_problems(stds)
    for x, y in zip(generate.pad_and_mask(ours), netlib.pad_and_mask(stds)):
        assert _same(x, y)


def _cell(name: str, **traffic_kw):
    cell = harness.load_cell(name)
    cell.traffic = {**cell.traffic, **traffic_kw}
    return cell


def test_dense_groups_are_one_pool_in_the_seeds_order():
    cell = _cell("dense64-scan", lps_per_group=10)
    work = traffic.make(cell.config, cell.traffic, 5)
    port = random_standard_lp(64, 64, nlp=40, seed=3, dtype=np.float32).to_equality_form()
    order = np.random.default_rng(5).permutation(40)
    assert len(work.groups) == 4 and len(work.batches) == 4
    for g, grp in enumerate(work.groups):
        assert _same(grp.A, port.A)
        assert _same(grp.b, port.b[order[10 * g:10 * (g + 1)]])
        assert _same(grp.c, port.c[order[10 * g:10 * (g + 1)]])
        assert work.batches[g].lanes == [(g, 0, 10)]
    other = traffic.make(cell.config, cell.traffic, 6)
    pool = lambda w: sorted(map(tuple, np.concatenate([g.b for g in w.groups])))  # noqa: E731
    assert pool(other) == pool(work) and not _same(other.groups[0].b, work.groups[0].b)


def _port_netlib(reps: int, seed: int):
    """The netlib buckets and the padded batch as the program's benchmark
    script builds them (``chip_smoke._netlib_buckets`` and
    ``_netlib_padded``, with the seed in place of its 7)."""
    names = netlib.fixture_names()
    stds = [netlib.load_fixture(nm).lp.to_standard_form()[0] for nm in names]
    rng = np.random.default_rng(seed)
    buckets = []
    for _, idxs in sorted(netlib.bucket_problems(stds).items()):
        i = idxs[0]
        eq = stds[i].to_equality_form()
        scale = (1.0 + 0.1 * rng.random((reps, 1))).astype(np.float32)
        b = np.asarray(eq.b, np.float32).reshape(1, -1) * scale
        c = np.ascontiguousarray(np.broadcast_to(np.asarray(eq.c, np.float32).reshape(1, -1),
                                                 (reps, eq.c.shape[-1])))
        buckets.append((i, np.asarray(eq.A, np.float32), b, c, scale[:, 0]))
    order = [i for i, *_ in buckets]
    A_pad, b_pad, c_pad, _, _ = netlib.pad_and_mask([stds[i] for i in order], np.float32)
    mp = A_pad.shape[1]
    eye = np.broadcast_to(np.eye(mp, dtype=np.float32), (len(order), mp, mp))
    A_eq = np.concatenate([A_pad, eye], axis=2)
    c_eq = np.concatenate([-c_pad, np.zeros((len(order), mp), np.float32)], axis=1)
    lane_of = np.repeat(np.arange(len(order)), reps)
    A3 = np.ascontiguousarray(A_eq[lane_of])
    b3 = b_pad[lane_of].copy()
    for k, (i, *_, scale) in enumerate(buckets):
        b3[k * reps:(k + 1) * reps, :stds[i].nrows] *= scale[:, None]
    return [names[i] for i in order], buckets, (A3, b3, np.ascontiguousarray(c_eq[lane_of]))


def test_netlib_buckets_and_padded_batch_as_the_program_built_them():
    names, buckets, padded = _port_netlib(6, 11)
    cell = _cell("netlib3-buckets", lps_per_group=6)
    work = traffic.make(cell.config, cell.traffic, 11)
    assert [g.name for g in work.groups] == names == ["afiro", "sc50a", "adlittle"]
    for grp, (_, A, b, c, _) in zip(work.groups, buckets):
        assert _same(grp.A, A) and _same(grp.b, b) and _same(grp.c, c)
    cell = _cell("netlib3-padded", lps_per_group=6)
    (batch,) = traffic.make(cell.config, cell.traffic, 11).batches
    assert all(_same(x, y) for x, y in zip((batch.A, batch.b, batch.c), padded))
    assert batch.lanes == [(0, 0, 6), (1, 0, 6), (2, 0, 6)]


@pytest.mark.parametrize("name", ["netlib3-buckets", "dense64-scan"])
def test_same_seed_same_inputs_other_seed_other_inputs(name):
    cell = _cell(name, lps_per_group=4)
    a = traffic.make(cell.config, cell.traffic, 2**31 + 3)
    b = traffic.make(cell.config, cell.traffic, 2**31 + 3)
    c = traffic.make(cell.config, cell.traffic, 2**31 + 4)
    assert all(_same(x.b, y.b) for x, y in zip(a.groups, b.groups))
    assert not any(_same(x.b, y.b) for x, y in zip(a.groups, c.groups))
