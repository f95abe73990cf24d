"""Whole-API parity: every public name of the JAX package against the port.

Every module of ``pycllp_tpu`` (walked with ``pkgutil.walk_packages``) is
mapped to its counterpart in ``pycllp_tpu_torch`` (``solvers.jax_hsd`` →
``solvers.torch_hsd``).  For every public name, re-exports included, the
port must have the name.  For every public callable, class and public
class method (inherited ones too; wrapped callables through
``inspect.unwrap``) the parameters must agree in name, order, kind and
default, the defaults compared by value.  Enums agree member by member,
module constants by value.

The recorded differences are :data:`ALLOWED`, each with its reason and the
place in ROADMAP.md that records it.  Any other difference is a fault of
the port, not an entry to add here.
"""

import dataclasses
import enum
import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import pycllp_tpu

# (kind, the names it covers, reason, where ROADMAP.md records it)
ALLOWED = (
    ("added keyword-only parameter", ("device", "generator"),
     "the port's entry points run on the card unless the caller asks for the CPU, and its "
     "random data comes from a torch.Generator where the reference takes a PRNG key",
     "ROADMAP §1, Decisions"),
    ("renamed parameter", ("axis -> mesh",),
     "parallel/ takes a torch.distributed mesh where the reference names a jax mesh axis",
     "ROADMAP §1, Decisions"),
    ("parameters differ", ("parallel.distributed.initialize", "parallel.initialize"),
     "torch.distributed takes init_method/world_size/rank (and a backend and a timeout) where "
     "jax.distributed takes coordinator_address/num_processes/process_id",
     "ROADMAP §1, Decisions"),
    ("fields differ", ("ops.df64.DFFactor",),
     "the card's wide factor is native FP64 (L, dinv), not double-single hi/lo pairs "
     "(Lh, Ll, dinv_h, dinv_l)",
     "ROADMAP §1, Decisions; §3 'δ of the wide factor'"),
    ("not carried", ("ops.df64.df_mul", "ops.df64.df_div", "ops.df64.df_sqrt",
                     "utils.profiling.V5E_PEAK_BF16_TFLOPS",
                     "utils.profiling.V5E_PEAK_F32_TFLOPS", "utils.profiling.V5E_HBM_GBPS",
                     "ops.batchlast.LANES", "ops.df64.LANES"),
     "double-single arithmetic used only inside the reference's Pallas kernels, the TPU v5e "
     "peak constants and the TPU's 128-lane block width: TPU internals with no meaning on "
     "the card",
     "ROADMAP §1, names missing from the port; Decisions"),
    ("renamed class", ("JaxHSDSolver -> TorchHSDSolver", "PallasHSDSolver -> CudaHSDSolver"),
     "the classes are named for their backend; their registry names match the reference's",
     "ROADMAP §1, names missing from the port"),
    ("added keyword-only parameter", ("bits", "mv_bits", "ozaki_bits", "ozaki_mv_bits",
                                      "stage_sync"),
     "the reference's environment knobs are arguments: the Ozaki widths of the wide sets, of "
     "the narrow set that carries them and of the registry solvers (PYCLLP_OZAKI_BITS / "
     "PYCLLP_OZAKI_MV_BITS, which the CLI maps to them; ozaki_mv_params takes its width as "
     "an optional last argument, as ozaki_params does), and hsd_solve_scan's stage_sync "
     "(PYCLLP_SCAN_SYNC); the library reads no environment variable",
     "ROADMAP §1, Decisions; §3 'The env knobs'"),
    ("added field with a default", ("ops.batchlast.PreparedBL.Wp",),
     "the fused-form set packs W once per A for fused_factor_bl; every construction and "
     "field of the reference's PreparedBL works unchanged",
     "ROADMAP §2, the _fused_factor_bl row"),
    ("level cap", ("ops.df64.OZAKI_MAX_LEVELS",),
     "ozaki_product_bl takes at most 24 levels with every slice scale a normal f32 power "
     "of two; a wide set whose widths exceed that for its A raises ValueError before any "
     "iteration, on every device (tests/test_torch_widths.py); the reference has no cap",
     "ROADMAP §1, Decisions"),
)

_ADDED_KWONLY = {n for kind, names, *_ in ALLOWED if kind == "added keyword-only parameter"
                 for n in names}
_RENAMED_PARAM = dict(n.split(" -> ") for kind, names, *_ in ALLOWED
                      if kind == "renamed parameter" for n in names)
_RENAMED_CLASS = dict(n.split(" -> ") for kind, names, *_ in ALLOWED
                      if kind == "renamed class" for n in names)
_NOT_CARRIED = {n for kind, names, *_ in ALLOWED if kind == "not carried" for n in names}
_PARAMS_DIFFER = {n for kind, names, *_ in ALLOWED if kind in ("parameters differ",
                                                               "fields differ") for n in names}
_ADDED_FIELDS = {n for kind, names, *_ in ALLOWED if kind == "added field with a default"
                 for n in names}


def _port_module_name(ref_name: str) -> str:
    port = "pycllp_tpu_torch" + ref_name[len("pycllp_tpu"):]
    return port.replace(".solvers.jax_hsd", ".solvers.torch_hsd")


def _reference_modules():
    names = ["pycllp_tpu"] + [
        m.name for m in pkgutil.walk_packages(pycllp_tpu.__path__, "pycllp_tpu.")
    ]
    return sorted(names)


def _short(ref_module: str, name: str) -> str:
    """``ops.df64.DFFactor`` for ``pycllp_tpu.ops.df64`` and ``DFFactor``."""
    rest = ref_module[len("pycllp_tpu"):].lstrip(".")
    return f"{rest}.{name}" if rest else name


def _public(module) -> dict:
    """The module's public names: its own and re-exported functions and
    classes of the package, and its constants (no modules, no names
    imported from other libraries)."""
    out = {}
    for name, value in vars(module).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if inspect.isclass(value) or inspect.isroutine(value) or callable(value):
            owner = getattr(value, "__module__", None) or ""
            if not owner.startswith("pycllp_tpu"):
                continue
        elif getattr(type(value), "__module__", "").split(".")[0] in ("typing", "typing_extensions"):
            continue
        out[name] = value
    return out


def _backend_free(name: str) -> str:
    for prefix in ("pallas_", "cuda_", "jax_", "torch_"):
        name = name.replace(prefix, "")
    return name


def _same_value(a, b) -> bool:
    """Equal by value across the two backends."""
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if inspect.isclass(a):
        return inspect.isclass(b) and _RENAMED_CLASS.get(a.__name__, a.__name__) == b.__name__
    if isinstance(a, enum.Enum):
        return isinstance(b, enum.Enum) and (type(a).__name__, a.name, a.value) == (
            type(b).__name__, b.name, b.value)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        if not (dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__):
            return False
        fa = [f.name for f in dataclasses.fields(a)]
        return fa == [f.name for f in dataclasses.fields(b)] and all(
            _same_value(getattr(a, f), getattr(b, f)) for f in fa)
    if hasattr(a, "prepare") and hasattr(a, "name"):  # kernel sets
        return type(a).__name__ == type(b).__name__ and _backend_free(a.name) == _backend_free(
            b.name)
    if inspect.isroutine(a) and inspect.isroutine(b):
        # a function of the array library (jnp.any) is the same-named torch function
        ra, rb = (getattr(f, "__module__", "") or "" for f in (a, b))
        if ra.startswith("jax") and rb.startswith("torch"):
            return a.__name__ == b.__name__
        return a is b
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same_value, a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_value(a[k], b[k]) for k in a)
    if isinstance(a, (np.dtype, type)) and isinstance(b, torch.dtype):
        return np.dtype(a).name == str(b).removeprefix("torch.")
    try:
        return type(a) is type(b) and bool(a == b)
    except Exception:
        return False


def _parameters(obj):
    try:
        return list(inspect.signature(inspect.unwrap(obj)).parameters.values())
    except (TypeError, ValueError):
        return None


def _compare_parameters(where: str, ref, port) -> list:
    """The differences between two callables' parameters that no entry of
    :data:`ALLOWED` covers, as messages."""
    if where in _PARAMS_DIFFER:
        return []
    pr, pp = _parameters(ref), _parameters(port)
    if pr is None or pp is None:
        return [] if pr is None and pp is None else [f"{where}: signature of one side only"]
    ref_names = {p.name for p in pr}
    added = [p for p in pp if p.name not in ref_names
             and _RENAMED_PARAM.get(p.name) is None
             and not any(_RENAMED_PARAM.get(r.name) == p.name for r in pr)]
    problems = []
    for p in added:
        if f"{where}.{p.name}" in _ADDED_FIELDS:
            if p.default is inspect.Parameter.empty or p is not pp[-1]:
                problems.append(f"{where}: added field {p.name} has no default or is not last")
        elif p.name not in _ADDED_KWONLY:
            problems.append(f"{where}: parameter {p.name!r} only in the port")
        elif p.kind is not inspect.Parameter.KEYWORD_ONLY and not (
                p is pp[-1] and p.default is not inspect.Parameter.empty):
            problems.append(f"{where}: added parameter {p.name!r} is not keyword-only")
    kept = [p for p in pp if p not in added]
    if len(kept) != len(pr):
        return problems + [f"{where}: parameters {[p.name for p in pr]} in the reference, "
                           f"{[p.name for p in kept]} in the port"]
    for r, p in zip(pr, kept):
        renamed = _RENAMED_PARAM.get(r.name) == p.name
        if r.name != p.name and not renamed:
            problems.append(f"{where}: parameter {r.name!r} is {p.name!r} in the port")
        if r.kind != p.kind:
            problems.append(f"{where}: parameter {r.name!r} is {r.kind.description} in the "
                            f"reference, {p.kind.description} in the port")
        if not renamed and not _same_value(r.default, p.default):
            problems.append(f"{where}: default of {r.name!r} is {r.default!r} in the "
                            f"reference, {p.default!r} in the port")
    return problems


def _methods(cls) -> dict:
    """Public methods of ``cls`` (inherited ones too), with ``__init__`` and
    ``__call__`` where the class defines them."""
    out = {}
    for name in dir(cls):
        if name.startswith("_") and name not in ("__init__", "__call__"):
            continue
        raw = inspect.getattr_static(cls, name)
        if name.startswith("__") and raw is getattr(object, name, None):
            continue
        if isinstance(raw, (staticmethod, classmethod)):
            raw = raw.__func__
        if inspect.isfunction(raw):
            out[name] = raw
    return out


def _compare_module(ref_name: str) -> list:
    ref = importlib.import_module(ref_name)
    port_name = _port_module_name(ref_name)
    try:
        port = importlib.import_module(port_name)
    except ImportError:
        return [f"{ref_name}: no counterpart {port_name}"]
    problems = []
    for name, value in _public(ref).items():
        where = _short(ref_name, name)
        if where in _NOT_CARRIED:
            assert not hasattr(port, name), f"{where} is carried now: take it off ALLOWED"
            continue
        pname = _RENAMED_CLASS.get(name, name)
        if not hasattr(port, pname):
            problems.append(f"{where}: missing from {port_name}")
            continue
        other = getattr(port, pname)
        if inspect.isclass(value):
            if not inspect.isclass(other):
                problems.append(f"{where}: a class in the reference only")
            elif issubclass(value, enum.Enum):
                ours = {m.name: m.value for m in other} if issubclass(other, enum.Enum) else None
                if ours != {m.name: m.value for m in value}:
                    problems.append(f"{where}: members differ")
            else:
                problems += _compare_parameters(where, value, other)
                port_methods = _methods(other)
                for mname, meth in _methods(value).items():
                    if mname not in port_methods:
                        problems.append(f"{where}.{mname}: missing from the port")
                    else:
                        problems += _compare_parameters(f"{where}.{mname}", meth,
                                                        port_methods[mname])
        elif inspect.isroutine(value) or callable(value) and not hasattr(value, "prepare"):
            problems += _compare_parameters(where, value, other)
        elif not _same_value(value, other):
            problems.append(f"{where}: {value!r} in the reference, {other!r} in the port")
    return problems


@pytest.mark.parametrize("ref_name", _reference_modules())
def test_module_api_matches_the_reference(ref_name):
    problems = _compare_module(ref_name)
    assert not problems, "\n".join(problems)


def test_the_walk_covers_the_package():
    """Every module of the reference is walked, each maps to a module of
    the port, and the allow-list names only things the walk meets."""
    names = _reference_modules()
    assert "pycllp_tpu.solvers.hsd" in names and "pycllp_tpu.parallel.dchol" in names
    assert len(names) == 36
    met = {_short(m, n) for m in names for n in _public(importlib.import_module(m))}
    for name in _NOT_CARRIED | _PARAMS_DIFFER:
        assert name in met, name
    for kind, _, reason, where in ALLOWED:
        assert reason and where.startswith("ROADMAP"), kind
