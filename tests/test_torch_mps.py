"""Port parity: the MPS reader/writer (io/mps.py).

Every reader case of ``tests/test_mps.py`` (the sample, fixed format,
RANGES, BOUNDS, OBJSENSE, the negative-UP quirk, extra N rows, integer
markers, RHS forms, comments) goes through both packages' ``read_mps``:
names and every ``GeneralLP`` array must be EXACTLY equal, and
``write_mps`` of the parsed LP must give identical text.  The writer →
reader fuzz round-trips of ``tests/test_mps.py`` (seeds 0–7) are held to
the same exactness.
"""

import numpy as np
import pytest

from pycllp_tpu.io import mps as ref_mps
from pycllp_tpu.models import GeneralLP as RefGeneralLP
from pycllp_tpu_torch.io import mps as port_mps
from pycllp_tpu_torch.models import GeneralLP

SAMPLE = """\
* classic tiny example
NAME          TESTPROB
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  MYEQN
COLUMNS
    X1  COST  1.0  LIM1  1.0
    X1  LIM2  1.0
    X2  COST  2.0  LIM1  1.0
    X2  MYEQN  -1.0
    X3  COST  -1.0  MYEQN  1.0
RHS
    RHS  LIM1  4.0  LIM2  1.0
    RHS  MYEQN  7.0
BOUNDS
 UP BND  X1  4.0
 LO BND  X2  -1.0
ENDATA
"""

FIXED_FORMAT = (
    "NAME          FIXEDFMT\n"
    "ROWS\n"
    " N  COST\n"
    " L  LIM1\n"
    " G  LIM2\n"
    " E  MYEQN\n"
    "COLUMNS\n"
    "    X1        COST         1.0   LIM1         1.0\n"
    "    X1        LIM2         1.0\n"
    "    X2        COST         2.0   LIM1         1.0\n"
    "    X2        MYEQN       -1.0\n"
    "    X3        COST        -1.0   MYEQN        1.0\n"
    "RHS\n"
    "    RHS       LIM1         4.0   LIM2         1.0\n"
    "    RHS       MYEQN        7.0\n"
    "BOUNDS\n"
    " UP BND       X1           4.0\n"
    " LO BND       X2          -1.0\n"
    "ENDATA\n"
)

_BOUNDS = " UP BND  X1  4.0\n LO BND  X2  -1.0\n"
_RHS = "    RHS  LIM1  4.0  LIM2  1.0\n    RHS  MYEQN  7.0\n"

READER_CASES = {
    "sample": SAMPLE,
    "fixed_format": FIXED_FORMAT,
    "objsense_section": SAMPLE.replace("ROWS\n", "OBJSENSE\n    MAX\nROWS\n"),
    "objsense_inline": SAMPLE.replace("ROWS\n", "OBJSENSE MAXIMIZE\nROWS\n"),
    "rhs_on_objective_row": SAMPLE.replace("RHS\n", "RHS\n    RHS  COST  2.5\n"),
    "rhs_without_set_name": SAMPLE.replace(_RHS, "    LIM1  4.0  LIM2  1.0\n    MYEQN  7.0\n"),
    "ranges_L_G_E": SAMPLE.replace(
        "BOUNDS\n", "RANGES\n    RNG  LIM1  2.0\n    RNG  LIM2  -3.0\n    RNG  MYEQN  1.5\nBOUNDS\n"
    ),
    "negative_range_on_E": SAMPLE.replace("BOUNDS\n", "RANGES\n    RNG  MYEQN  -1.5\nBOUNDS\n"),
    "bounds_fr_mi_pl": SAMPLE.replace(_BOUNDS, " FR BND  X1\n MI  X2\n PL BND  X3\n"),
    "bounds_bv_fx": SAMPLE.replace(_BOUNDS, " BV BND  X1\n FX BND  X2  1.25\n"),
    "negative_up_quirk": SAMPLE.replace(" UP BND  X1  4.0\n", " UP BND  X1  -2.0\n"),
    "negative_up_after_lo": SAMPLE.replace(_BOUNDS, " LO BND  X1  -5.0\n UP BND  X1  -2.0\n"),
    "extra_N_rows": SAMPLE.replace(" L  LIM1\n", " L  LIM1\n N  FREEROW\n").replace(
        "    X1  LIM2  1.0\n", "    X1  LIM2  1.0  FREEROW  9.0\n"
    ),
    "integer_marker": SAMPLE.replace(
        "COLUMNS\n", "COLUMNS\n    MARK  'MARKER'  'INTORG'\n"
    ).replace("    X3  COST", "    MARK  'MARKER'  'INTEND'\n    X3  COST"),
    "comments_and_blank_lines": "\n".join(
        part for ln in SAMPLE.splitlines() for part in (ln, "* interleaved comment", "")
    ) + "\n",
    "duplicate_objective_entries": SAMPLE.replace(
        "    X1  COST  1.0  LIM1  1.0\n", "    X1  COST  0.5  LIM1  1.0\n    X1  COST  0.5\n"
    ),
}

_FIELDS = ("A", "row_lb", "row_ub", "c", "lb", "ub")


def _assert_same_lp(port_lp, ref_lp):
    port_lp._freeze()
    ref_lp._freeze()
    for f in _FIELDS:
        p, r = np.asarray(getattr(port_lp, f)), np.asarray(getattr(ref_lp, f))
        assert p.dtype == r.dtype and p.shape == r.shape, f
        np.testing.assert_array_equal(p, r, err_msg=f)
    assert float(port_lp.f) == float(ref_lp.f)
    assert port_lp.sense == ref_lp.sense


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_cases_match_reference(case):
    text = READER_CASES[case]
    port, ref = port_mps.read_mps(text), ref_mps.read_mps(text)
    assert (port.name, port.row_names, port.col_names, port.objective_name, port.shape) == (
        ref.name, ref.row_names, ref.col_names, ref.objective_name, ref.shape
    )
    _assert_same_lp(port.lp, ref.lp)
    kw = dict(name=port.name, row_names=port.row_names, col_names=port.col_names)
    assert port_mps.write_mps(port.lp, **kw) == ref_mps.write_mps(ref.lp, **kw)


def test_reader_from_path_and_file_object(tmp_path):
    path = tmp_path / "sample.mps"
    path.write_text(SAMPLE)
    _assert_same_lp(port_mps.read_mps(str(path)).lp, ref_mps.read_mps(str(path)).lp)
    with open(path) as fh:
        _assert_same_lp(port_mps.read_mps(fh).lp, ref_mps.read_mps(SAMPLE).lp)


def test_missing_objective_raises_in_both():
    text = SAMPLE.replace(" N  COST\n", "")
    for mod in (port_mps, ref_mps):
        with pytest.raises(ValueError, match="no objective"):
            mod.read_mps(text)


def _fuzz_arrays(seed):
    """tests/test_mps.py's random GeneralLP with every bound/row pattern."""
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(1, 8)), int(rng.integers(1, 10))
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.6)
    row_lb = np.full(m, -np.inf)
    row_ub = np.full(m, np.inf)
    for i in range(m):
        kind = rng.integers(0, 5)
        h = float(np.round(rng.normal(), 3))
        if kind == 0:
            row_ub[i] = h
        elif kind == 1:
            row_lb[i] = h
        elif kind == 2:
            row_lb[i] = row_ub[i] = h
        elif kind == 3:
            row_lb[i], row_ub[i] = h - abs(float(rng.normal())) - 0.1, h
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    for j in range(n):
        kind = rng.integers(0, 5)
        v = float(np.round(rng.normal(), 3))
        if kind == 0:
            ub[j] = abs(v) + 0.1
        elif kind == 1:
            lb[j] = v
        elif kind == 2:
            lb[j] = ub[j] = v
        elif kind == 3:
            lb[j] = -np.inf
    return dict(A=A, row_lb=row_lb, row_ub=row_ub, c=np.round(rng.normal(size=n), 3),
                lb=lb, ub=ub, f=float(np.round(rng.normal(), 3)),
                sense="max" if seed % 2 else "min")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_roundtrip_matches_reference(seed):
    kw = _fuzz_arrays(seed)
    text = port_mps.write_mps(GeneralLP(**kw))
    assert text == ref_mps.write_mps(RefGeneralLP(**kw))
    _assert_same_lp(port_mps.read_mps(text).lp, ref_mps.read_mps(text).lp)
