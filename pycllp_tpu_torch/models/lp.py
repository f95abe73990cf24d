"""LP problem containers and form conversions (numpy only).

Counterpart of :mod:`pycllp_tpu.models.lp`.  Three forms:

* :class:`GeneralLP` — ``opt cᵀx + f  s.t.  row_lb ≤ Ax ≤ row_ub,
  l ≤ x ≤ u`` with min/max sense.  Built incrementally or from arrays.
* :class:`StandardLP` — the Vanderbei convention the upstream library
  standardises on: ``max cᵀx + f  s.t.  Ax ≤ b, x ≥ 0``.
* :class:`EqualityLP` — ``min cᵀx  s.t.  Ax = b, x ≥ 0`` — the internal
  form the HSD interior-point solvers consume (slack-augmented).

Batching ("many scenarios, one structure"): ``b`` and ``c`` may carry a
leading ``(nlp,)`` problems axis while ``A`` stays shared ``(m, n)``;
``A`` may also be batched ``(nlp, m, n)`` for the varying-structure case.
The containers hold host numpy arrays; the solvers move the data to the
requested device.  (The reference registers them as JAX pytrees; nothing
here needs that.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from pycllp_tpu_torch.models.sparse import SparseMatrixBuilder, csc_to_dense

__all__ = ["BaseLP", "GeneralLP", "StandardLP", "EqualityLP", "StandardFormMap"]

_INF = np.inf


class BaseLP:
    """Shared helpers for LP containers."""

    @property
    def nrows(self) -> int:
        return self.A.shape[-2]

    @property
    def ncols(self) -> int:
        return self.A.shape[-1]

    @property
    def nproblems(self) -> int:
        """Size of the leading scenario axis (1 if unbatched)."""
        for arr in (self.b, self.c):
            if np.ndim(arr) >= 2:
                return np.shape(arr)[0]
        if np.ndim(self.A) >= 3:
            return np.shape(self.A)[0]
        return 1

    @property
    def batched(self) -> bool:
        return np.ndim(self.b) >= 2 or np.ndim(self.c) >= 2 or np.ndim(self.A) >= 3


@dataclass
class StandardLP(BaseLP):
    """``max cᵀx + f  s.t.  Ax ≤ b, x ≥ 0`` (Vanderbei convention).

    ``A`` is dense; CSC construction/round-trip is supported via
    :meth:`from_csc` / :meth:`tocsc`.
    """

    A: Any  # (m, n) or (nlp, m, n)
    b: Any  # (m,) or (nlp, m)
    c: Any  # (n,) or (nlp, n)
    f: Any = 0.0  # objective constant, scalar or (nlp,)

    def __post_init__(self):
        self.A = np.asarray(self.A)
        self.b = np.asarray(self.b)
        self.c = np.asarray(self.c)

    @classmethod
    def from_csc(cls, a, ia, ka, b, c, f=0.0, nrows: int | None = None) -> "StandardLP":
        m = int(nrows) if nrows is not None else int(np.max(ia)) + 1
        return cls(A=csc_to_dense(a, ia, ka, m), b=b, c=c, f=f)

    @classmethod
    def from_builder(cls, builder: SparseMatrixBuilder, b, c, f=0.0) -> "StandardLP":
        return cls(A=builder.todense(), b=b, c=c, f=f)

    def tocsc(self):
        if np.ndim(self.A) != 2:
            raise ValueError("tocsc requires an unbatched (m, n) A")
        return SparseMatrixBuilder.from_dense(np.asarray(self.A)).tocsc()

    def to_equality_form(self) -> "EqualityLP":
        """Slack-augment to ``min c̃ᵀx̃  s.t.  Ãx̃ = b, x̃ ≥ 0``.

        ``Ã = [A | I]``, ``c̃ = [−c; 0]`` (max → min).  The first ``n``
        entries of the equality solution are the original x; the dual of
        the equality form relates to the standard dual by ``y_std = −ỹ``.
        """
        A, b, c = self.A, self.b, self.c
        m, n = A.shape[-2], A.shape[-1]
        eye = np.eye(m, dtype=np.asarray(A).dtype)
        if np.ndim(A) == 3:
            eye = np.broadcast_to(eye, (A.shape[0], m, m))
        A_eq = np.concatenate([np.asarray(A), eye], axis=-1)
        zeros = np.zeros(np.shape(c)[:-1] + (m,), dtype=np.asarray(c).dtype)
        c_eq = np.concatenate([-np.asarray(c), zeros], axis=-1)
        return EqualityLP(A=A_eq, b=b, c=c_eq, n_structural=n, source="standard", f=self.f)


@dataclass
class EqualityLP(BaseLP):
    """``min cᵀx  s.t.  Ax = b, x ≥ 0`` — the solver-internal form."""

    A: Any
    b: Any
    c: Any
    f: Any = 0.0
    n_structural: int = -1  # columns belonging to the originating form
    source: str = "equality"  # "standard" | "equality"

    def __post_init__(self):
        if self.n_structural < 0:
            self.n_structural = self.A.shape[-1]

    def recover_standard_solution(self, x_eq, y_eq):
        """Map an equality-form primal/dual back to the Vanderbei form.

        Returns ``(x, w, y)`` — original primal, slacks, standard dual
        (``y_std = −y_eq`` because the equality form minimises −c).
        """
        n = self.n_structural
        return x_eq[..., :n], x_eq[..., n:], -y_eq

    def standard_objective(self, x_eq):
        """Objective of the originating ``max`` form: ``−cᵀx̃ + f``."""
        return -np.sum(np.asarray(self.c) * np.asarray(x_eq), axis=-1) + self.f


@dataclass
class StandardFormMap:
    """Recovery metadata from :meth:`GeneralLP.to_standard_form`.

    The standard-form variable vector ``x_std`` maps back to the general
    variables via ``x = offset + sign * x_std[pos] (+ x_std[neg] for
    splits)``; ``sense`` is +1 for an original max, −1 for min (standard
    form always maximises).
    """

    n_vars: int
    pos_col: np.ndarray  # (n_vars,) index of the + column in x_std
    neg_col: np.ndarray  # (n_vars,) index of the − column, or -1
    sign: np.ndarray  # (n_vars,) ±1 applied to pos column
    offset: np.ndarray  # (n_vars,) constant shift
    sense: float  # +1 max, −1 min
    n_std_rows: int
    row_of: np.ndarray  # (n_std_rows,) original row index of each std row
    row_sign: np.ndarray  # (n_std_rows,) ±1: std row = sign * original row

    def recover_x(self, x_std):
        x = self.sign * np.take(np.asarray(x_std), self.pos_col, axis=-1) + self.offset
        has_neg = self.neg_col >= 0
        if np.any(has_neg):
            neg = np.take(np.asarray(x_std), np.where(has_neg, self.neg_col, 0), axis=-1)
            x = x - np.where(has_neg, neg, 0.0)
        return x

    def recover_objective(self, obj_std):
        """General-form objective from the standard-form objective."""
        return self.sense * np.asarray(obj_std)

    def recover_duals(self, y_std):
        """General-form row duals: fold the ± split rows back together."""
        y = np.asarray(y_std)
        out_shape = y.shape[:-1] + (int(self.row_of.max()) + 1 if self.n_std_rows else 0,)
        out = np.zeros(out_shape, dtype=y.dtype)
        np.add.at(
            np.moveaxis(out, -1, 0),
            self.row_of,
            np.moveaxis(y * self.row_sign * self.sense, -1, 0),
        )
        return out


class GeneralLP(BaseLP):
    """General-form LP: ``opt cᵀx + f  s.t.  row_lb ≤ Ax ≤ row_ub, l ≤ x ≤ u``.

    Rows are expressed by per-row lower/upper bounds (``−inf``/``inf`` for
    one-sided; equal for equality rows).
    """

    def __init__(
        self,
        A=None,
        row_ub=None,
        c=None,
        *,
        row_lb=None,
        lb=None,
        ub=None,
        f=0.0,
        sense: str = "min",
    ):
        if A is None:
            A = SparseMatrixBuilder()
        if isinstance(A, SparseMatrixBuilder):
            self._builder = A
            self.A = None
        else:
            self._builder = None
            self.A = np.asarray(A, dtype=np.float64)
        self.row_ub = None if row_ub is None else np.asarray(row_ub, dtype=np.float64)
        self.row_lb = None if row_lb is None else np.asarray(row_lb, dtype=np.float64)
        self.c = None if c is None else np.asarray(c, dtype=np.float64)
        self.lb = None if lb is None else np.asarray(lb, dtype=np.float64)
        self.ub = None if ub is None else np.asarray(ub, dtype=np.float64)
        self.f = f
        if sense not in ("min", "max"):
            raise ValueError("sense must be 'min' or 'max'")
        self.sense = sense

    # -- incremental construction ----------------------------------------

    def set_value(self, i: int, j: int, v: float) -> None:
        if self._builder is None:
            self._builder = SparseMatrixBuilder.from_dense(self.A)
            self.A = None
        self._builder[i, j] = v

    def _freeze(self):
        if self.A is None:
            self.A = self._builder.todense()
        m, n = self.A.shape
        self.row_ub = np.full(m, _INF) if self.row_ub is None else self.row_ub
        self.row_lb = np.full(m, -_INF) if self.row_lb is None else self.row_lb
        self.c = np.zeros(n) if self.c is None else self.c
        self.lb = np.zeros(n) if self.lb is None else self.lb
        self.ub = np.full(n, _INF) if self.ub is None else self.ub

    @property
    def b(self):  # BaseLP compat: the row upper bounds play the role of b
        return self.row_ub

    # -- conversion -------------------------------------------------------

    def to_standard_form(self) -> tuple[StandardLP, StandardFormMap]:
        """Convert to ``max cᵀx + f, Ax ≤ b, x ≥ 0`` plus recovery map.

        Steps (the classic reductions, vectorised over any batch axes on
        ``row_*``/``c``):

        1. variables: finite-lb → shift; (-inf, finite-ub] → reflect;
           free → split into x⁺ − x⁻; finite ub after shift → extra row.
        2. rows: upper bounds stay; lower bounds negate; equalities and
           ranges emit both rows.
        3. sense: min → negate c.
        """
        self._freeze()
        A, c = self.A, self.c
        m, n = A.shape
        sense = 1.0 if self.sense == "max" else -1.0

        # --- variable transformation -> columns of the std matrix
        cols: list[np.ndarray] = []  # each (m,) column of transformed A
        pos_col = np.zeros(n, dtype=np.int64)
        neg_col = np.full(n, -1, dtype=np.int64)
        sign = np.ones(n)
        offset = np.zeros(n)
        ub_rows: list[tuple[int, float]] = []  # (std col, bound) rows to append

        for j in range(n):
            lj, uj = self.lb[j], self.ub[j]
            if np.isfinite(lj):
                pos_col[j] = len(cols)
                sign[j] = 1.0
                offset[j] = lj
                cols.append(A[:, j])
                if np.isfinite(uj):
                    ub_rows.append((pos_col[j], uj - lj))
            elif np.isfinite(uj):  # (-inf, u]: x = u − x', x' ≥ 0
                pos_col[j] = len(cols)
                sign[j] = -1.0
                offset[j] = uj
                cols.append(-A[:, j])
            else:  # free: x = x⁺ − x⁻
                pos_col[j] = len(cols)
                cols.append(A[:, j])
                neg_col[j] = len(cols)
                cols.append(-A[:, j])

        n_std = len(cols)
        A_var = np.stack(cols, axis=1) if n_std else np.zeros((m, 0))

        # objective in transformed vars: c·x = c·offset + Σ c_j sign_j x'_pos
        # (+ free splits); constant folds into f.
        c_std = np.zeros(np.shape(c)[:-1] + (n_std,))
        cj = np.moveaxis(np.asarray(c), -1, 0)  # (n, ...) for batched c
        for j in range(n):
            np.moveaxis(c_std, -1, 0)[pos_col[j]] += cj[j] * sign[j]
            if neg_col[j] >= 0:
                np.moveaxis(c_std, -1, 0)[neg_col[j]] -= cj[j]
        f_std = self.f + np.sum(np.asarray(c) * offset, axis=-1)

        # --- rows: adjust bounds for the variable shift, then split
        shift = A @ np.where(np.isfinite(self.lb), self.lb, np.where(np.isfinite(self.ub), self.ub, 0.0))
        row_ub = self.row_ub - shift
        row_lb = self.row_lb - shift

        std_rows: list[np.ndarray] = []
        std_b: list = []
        row_of: list[int] = []
        row_sign: list[float] = []
        for i in range(m):
            has_ub = np.all(np.isfinite(np.asarray(row_ub)[..., i]))
            has_lb = np.all(np.isfinite(np.asarray(row_lb)[..., i]))
            if has_ub:
                std_rows.append(A_var[i])
                std_b.append(np.asarray(row_ub)[..., i])
                row_of.append(i)
                row_sign.append(1.0)
            if has_lb:
                std_rows.append(-A_var[i])
                std_b.append(-np.asarray(row_lb)[..., i])
                row_of.append(i)
                row_sign.append(-1.0)
        for col, bound in ub_rows:
            e = np.zeros(n_std)
            e[col] = 1.0
            std_rows.append(e)
            std_b.append(np.broadcast_to(np.asarray(bound), np.shape(np.asarray(row_ub))[:-1]))
            row_of.append(-1)
            row_sign.append(0.0)

        A_std = np.stack(std_rows, axis=0) if std_rows else np.zeros((0, n_std))
        b_std = np.stack(std_b, axis=-1) if std_b else np.zeros(np.shape(row_ub)[:-1] + (0,))

        lp = StandardLP(A=A_std, b=b_std, c=sense * c_std, f=sense * np.asarray(f_std))
        fmap = StandardFormMap(
            n_vars=n,
            pos_col=pos_col,
            neg_col=neg_col,
            sign=sign,
            offset=offset,
            sense=sense,
            n_std_rows=len(row_of),
            row_of=np.asarray(row_of, dtype=np.int64),
            row_sign=np.asarray(row_sign),
        )
        return lp, fmap
