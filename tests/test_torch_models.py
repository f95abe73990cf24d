"""Port parity: problem containers, generators and Ruiz scaling.

The same numpy inputs go through the JAX package (the reference) and
``pycllp_tpu_torch``; conversions must agree exactly, the generators
bit for bit, and the scaling to 1e-12 in f64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycllp_tpu.models as ref_models
import pycllp_tpu_torch.models as port_models
from pycllp_tpu.io import generate as ref_gen
from pycllp_tpu.utils import scaling as ref_scaling
from pycllp_tpu_torch.io import generate as port_gen
from pycllp_tpu_torch.utils import scaling as port_scaling


@pytest.mark.parametrize(
    "m,n,nlp,seed,dtype,shared_A",
    [
        (5, 7, 0, 0, np.float64, True),
        (8, 8, 16, 3, np.float32, True),
        (4, 9, 5, 11, np.float64, False),
        (64, 64, 32, 3, np.float32, True),
    ],
)
def test_random_standard_lp_bit_identical(m, n, nlp, seed, dtype, shared_A):
    ref = ref_gen.random_standard_lp(m, n, nlp=nlp, seed=seed, dtype=dtype, shared_A=shared_A)
    port = port_gen.random_standard_lp(m, n, nlp=nlp, seed=seed, dtype=dtype, shared_A=shared_A)
    for f in ("A", "b", "c"):
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(port, f))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nlp,shared_A", [(0, True), (6, True), (6, False)])
def test_random_equality_lp_bit_identical(nlp, shared_A):
    ref = ref_gen.random_equality_lp(6, 14, nlp=nlp, seed=4, shared_A=shared_A)
    port = port_gen.random_equality_lp(6, 14, nlp=nlp, seed=4, shared_A=shared_A)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("nlp,shared_A", [(0, True), (7, True), (7, False)])
def test_to_equality_form_matches(nlp, shared_A):
    lp_np = ref_gen.random_standard_lp(5, 8, nlp=nlp, seed=2, shared_A=shared_A)
    ref = ref_models.StandardLP(A=lp_np.A, b=lp_np.b, c=lp_np.c, f=1.5).to_equality_form()
    port = port_models.StandardLP(A=lp_np.A, b=lp_np.b, c=lp_np.c, f=1.5).to_equality_form()
    for f in ("A", "b", "c", "f"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), np.asarray(getattr(port, f)))
    assert (ref.n_structural, ref.source) == (port.n_structural, port.source)
    x_eq = np.random.default_rng(0).uniform(size=np.shape(port.c))
    np.testing.assert_array_equal(ref.standard_objective(x_eq), port.standard_objective(x_eq))


def _general_lp(mod, batched_c: bool, sense: str):
    """Every reduction at once: shifted, reflected, boxed and free variables;
    upper, lower, range and equality rows."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 5))
    c = rng.normal(size=(3, 5)) if batched_c else rng.normal(size=5)
    return mod.GeneralLP(
        A=A,
        row_ub=[1.0, np.inf, 2.0, 0.5],
        row_lb=[-np.inf, -1.0, -2.0, 0.5],
        c=c,
        lb=[0.0, -np.inf, 1.0, -np.inf, -2.0],
        ub=[np.inf, 3.0, 4.0, np.inf, np.inf],
        f=0.25,
        sense=sense,
    )


@pytest.mark.parametrize("batched_c", [False, True])
@pytest.mark.parametrize("sense", ["min", "max"])
def test_general_to_standard_form_matches(batched_c, sense):
    ref_lp, ref_map = _general_lp(ref_models, batched_c, sense).to_standard_form()
    port_lp, port_map = _general_lp(port_models, batched_c, sense).to_standard_form()
    for f in ("A", "b", "c", "f"):
        np.testing.assert_array_equal(np.asarray(getattr(ref_lp, f)), np.asarray(getattr(port_lp, f)))
    for f in ("n_vars", "pos_col", "neg_col", "sign", "offset", "sense", "n_std_rows",
              "row_of", "row_sign"):
        np.testing.assert_array_equal(getattr(ref_map, f), getattr(port_map, f))
    rng = np.random.default_rng(1)
    x_std = rng.uniform(size=np.shape(port_lp.c))
    y_std = rng.normal(size=np.shape(port_lp.b))
    np.testing.assert_array_equal(ref_map.recover_x(x_std), port_map.recover_x(x_std))
    np.testing.assert_array_equal(ref_map.recover_duals(y_std), port_map.recover_duals(y_std))


@pytest.mark.parametrize("a_shape", [(6, 10), (3, 6, 10)])
def test_ruiz_scaling_matches(a_shape):
    rng = np.random.default_rng(3)
    A = rng.normal(size=a_shape) * rng.uniform(0.01, 100.0, size=a_shape)
    b = rng.normal(size=(4,) + a_shape[-2:-1]) if len(a_shape) == 2 else rng.normal(size=a_shape[:-1])
    c = rng.normal(size=(4,) + a_shape[-1:]) if len(a_shape) == 2 else rng.normal(size=a_shape[:1] + a_shape[-1:])
    ref = ref_scaling.ruiz_equilibrate(jnp.asarray(A))
    port = port_scaling.ruiz_equilibrate(torch.from_numpy(A))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12, atol=0)
    ref_s = ref_scaling.scale_problem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), ref)
    port_s = port_scaling.scale_problem(torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(c), port)
    for r, p in zip(ref_s, port_s):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12, atol=0)
    x, y, z = (rng.uniform(0.1, 1.0, size=v.shape) for v in (c, b, c))
    ref_u = ref_scaling.unscale_solution(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), ref)
    port_u = port_scaling.unscale_solution(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z), port
    )
    for r, p in zip(ref_u, port_u):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12, atol=0)
