"""MPS LP-file reader/writer.

Counterpart of :mod:`pycllp_tpu.io.mps`, line for line (numpy only): the
same text gives the same :class:`GeneralLP` arrays, and the same LP the
same text.  Free-format MPS: NAME, OBJSENSE, ROWS (N/L/G/E), COLUMNS
(integer markers tolerated as LP relaxation), RHS, RANGES, BOUNDS
(UP/LO/FX/FR/MI/PL/BV), ENDATA.

Conventions and deliberate simplifications:

* the FIRST ``N`` row is the objective; any further ``N`` (free) rows are
  dropped, along with their COLUMNS entries — free rows never constrain
  the LP and real netlib files use at most one;
* an RHS entry on the objective row sets the objective constant with the
  canonical ``f = -value`` sign;
* integer markers are accepted and ignored (LP relaxation).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from pycllp_tpu_torch.models import GeneralLP, SparseMatrixBuilder

__all__ = ["read_mps", "write_mps", "MPSProblem"]

_INF = np.inf


@dataclass
class MPSProblem:
    """Parsed MPS data plus name metadata."""

    name: str
    lp: GeneralLP
    row_names: list[str]
    col_names: list[str]
    objective_name: str

    @property
    def shape(self):
        return (len(self.row_names), len(self.col_names))


def read_mps(source) -> MPSProblem:
    """Parse MPS from a path, file object, or string."""
    if hasattr(source, "read"):
        text = source.read()
    elif isinstance(source, str) and "\n" in source:
        text = source
    else:
        with open(source) as f:
            text = f.read()

    name = ""
    sense = "min"
    section = None
    obj_name = None
    row_sense: dict[str, str] = {}
    row_order: list[str] = []
    row_index: dict[str, int] = {}
    col_order: list[str] = []
    col_index: dict[str, int] = {}
    entries = SparseMatrixBuilder()
    obj_coefs: dict[int, float] = {}
    rhs: dict[str, float] = {}
    ranges: dict[str, float] = {}
    lb: dict[int, float] = {}
    ub: dict[int, float] = {}
    obj_const = 0.0
    in_integer = False

    def col_id(cname: str) -> int:
        if cname not in col_index:
            col_index[cname] = len(col_order)
            col_order.append(cname)
        return col_index[cname]

    for raw in io.StringIO(text):
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        if not line[0].isspace():  # section header
            parts = line.split()
            section = parts[0].upper()
            if section == "NAME":
                name = parts[1] if len(parts) > 1 else ""
            elif section == "OBJSENSE" and len(parts) > 1:
                sense = "max" if parts[1].upper().startswith("MAX") else "min"
            elif section == "ENDATA":
                break
            continue
        parts = line.split()
        if section == "OBJSENSE":
            sense = "max" if parts[0].upper().startswith("MAX") else "min"
        elif section == "ROWS":
            rs, rname = parts[0].upper(), parts[1]
            if rs == "N":
                if obj_name is None:
                    obj_name = rname
                # extra N rows are ignored (free rows)
            else:
                row_sense[rname] = rs
                row_index[rname] = len(row_order)
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                marker = parts[2].upper().strip("'")
                in_integer = marker == "INTORG"
                continue
            cname = parts[0]
            j = col_id(cname)
            for rname, val in zip(parts[1::2], parts[2::2]):
                v = float(val)
                if rname == obj_name:
                    obj_coefs[j] = obj_coefs.get(j, 0.0) + v
                elif rname in row_sense:
                    entries.add_value(row_index[rname], j, v)
                # values for unknown/free rows are dropped
        elif section == "RHS":
            # first token is the RHS set name (may be omitted in the wild)
            toks = parts if parts[0] in row_sense or parts[0] == obj_name else parts[1:]
            for rname, val in zip(toks[0::2], toks[1::2]):
                if rname == obj_name:
                    obj_const = -float(val)  # MPS: RHS on objective row
                elif rname in row_sense:
                    rhs[rname] = float(val)
        elif section == "RANGES":
            toks = parts if parts[0] in row_sense else parts[1:]
            for rname, val in zip(toks[0::2], toks[1::2]):
                if rname in row_sense:
                    ranges[rname] = float(val)
        elif section == "BOUNDS":
            btype = parts[0].upper()
            # "BND COL VAL" or "BND SET COL VAL"
            if btype in ("FR", "MI", "PL", "BV"):
                # "FR BNDSET COL" (3 tokens) or "FR COL" (2 tokens)
                cname = parts[2] if len(parts) >= 3 else parts[1]
                j = col_id(cname)
                if btype == "FR":
                    lb[j] = -_INF
                elif btype == "MI":
                    lb[j] = -_INF
                elif btype == "PL":
                    ub[j] = _INF
                elif btype == "BV":
                    lb[j], ub[j] = 0.0, 1.0
            else:
                cname, val = parts[-2], float(parts[-1])
                j = col_id(cname)
                if btype == "UP":
                    ub[j] = val
                    if val < 0 and j not in lb:
                        lb[j] = -_INF  # classic MPS quirk
                elif btype == "LO":
                    lb[j] = val
                elif btype == "FX":
                    lb[j] = ub[j] = val

    if obj_name is None:
        raise ValueError("MPS file has no objective (N) row")
    m, n = len(row_order), len(col_order)
    A = np.zeros((m, n))
    for (i, j), v in entries._entries.items():
        A[i, j] = v
    row_lb = np.full(m, -_INF)
    row_ub = np.full(m, _INF)
    for i, rname in enumerate(row_order):
        h = rhs.get(rname, 0.0)
        s = row_sense[rname]
        if s == "L":
            row_ub[i] = h
        elif s == "G":
            row_lb[i] = h
        elif s == "E":
            row_lb[i] = row_ub[i] = h
        if rname in ranges:
            r = ranges[rname]
            if s == "L":
                row_lb[i] = h - abs(r)
            elif s == "G":
                row_ub[i] = h + abs(r)
            elif s == "E":
                if r >= 0:
                    row_ub[i] = h + r
                else:
                    row_lb[i] = h + r
    c = np.zeros(n)
    for j, v in obj_coefs.items():
        c[j] = v
    lbv = np.zeros(n)
    ubv = np.full(n, _INF)
    for j, v in lb.items():
        lbv[j] = v
    for j, v in ub.items():
        ubv[j] = v

    lp = GeneralLP(
        A=A, row_lb=row_lb, row_ub=row_ub, c=c, lb=lbv, ub=ubv, f=obj_const, sense=sense
    )
    return MPSProblem(
        name=name,
        lp=lp,
        row_names=row_order,
        col_names=col_order,
        objective_name=obj_name,
    )


def write_mps(lp: GeneralLP, name: str = "LP", row_names=None, col_names=None) -> str:
    """Serialise a GeneralLP to free-format MPS text."""
    lp._freeze()
    m, n = lp.A.shape
    row_names = row_names or [f"R{i}" for i in range(m)]
    col_names = col_names or [f"C{j}" for j in range(n)]
    out = [f"NAME          {name}"]
    if lp.sense == "max":
        out.append("OBJSENSE\n    MAX")
    out.append("ROWS")
    out.append(" N  COST")
    senses = []
    for i in range(m):
        lo, hi = lp.row_lb[i], lp.row_ub[i]
        if np.isfinite(lo) and np.isfinite(hi) and lo == hi:
            s = "E"
        elif np.isfinite(hi):
            s = "L"
        elif np.isfinite(lo):
            s = "G"
        else:
            s = "N"  # free row
        senses.append(s)
        out.append(f" {s}  {row_names[i]}")
    out.append("COLUMNS")
    for j in range(n):
        if lp.c[j]:
            out.append(f"    {col_names[j]}  COST  {lp.c[j]:.17g}")
        for i in range(m):
            if lp.A[i, j]:
                out.append(f"    {col_names[j]}  {row_names[i]}  {lp.A[i, j]:.17g}")
    out.append("RHS")
    if lp.f:
        out.append(f"    RHS  COST  {-lp.f:.17g}")
    for i in range(m):
        s = senses[i]
        h = lp.row_ub[i] if s in ("L", "E") else lp.row_lb[i]
        if s != "N" and h:
            out.append(f"    RHS  {row_names[i]}  {h:.17g}")
    out.append("RANGES")
    for i in range(m):
        lo, hi = lp.row_lb[i], lp.row_ub[i]
        if np.isfinite(lo) and np.isfinite(hi) and lo != hi:
            out.append(f"    RNG  {row_names[i]}  {hi - lo:.17g}")
    out.append("BOUNDS")
    for j in range(n):
        lo, hi = lp.lb[j], lp.ub[j]
        if lo == hi:
            out.append(f" FX BND  {col_names[j]}  {lo:.17g}")
            continue
        if not np.isfinite(lo):
            out.append(f" MI BND  {col_names[j]}")
        elif lo:
            out.append(f" LO BND  {col_names[j]}  {lo:.17g}")
        if np.isfinite(hi):
            out.append(f" UP BND  {col_names[j]}  {hi:.17g}")
    out.append("ENDATA")
    return "\n".join(out) + "\n"
