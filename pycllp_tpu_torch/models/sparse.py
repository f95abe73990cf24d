"""Incremental sparse-matrix construction (numpy only).

Counterpart of :mod:`pycllp_tpu.models.sparse`, unchanged in behaviour.
The builder collects coordinate entries host-side, then freezes to either

* CSC arrays ``(A, iA, kA)`` — the Vanderbei-convention layout the upstream
  solvers consume (values, row indices, column pointers), kept for API and
  test parity; or
* a dense ``(m, n)`` ndarray — the layout the batched device path consumes
  (problems in the batched regime are small and dense-padded).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SparseMatrixBuilder"]


class SparseMatrixBuilder:
    """Dict-of-coordinates builder: ``builder[i, j] = v``, then freeze.

    Duplicate assignment to the same coordinate overwrites (matching the
    set-value semantics of the upstream builder, not accumulate semantics).
    """

    def __init__(self, nrows: int | None = None, ncols: int | None = None):
        self._entries: dict[tuple[int, int], float] = {}
        self._nrows = nrows
        self._ncols = ncols

    # -- construction -----------------------------------------------------

    def __setitem__(self, key: tuple[int, int], value: float) -> None:
        i, j = int(key[0]), int(key[1])
        if i < 0 or j < 0:
            raise IndexError(f"negative index {(i, j)}")
        if self._nrows is not None and i >= self._nrows:
            raise IndexError(f"row {i} out of range for {self._nrows} rows")
        if self._ncols is not None and j >= self._ncols:
            raise IndexError(f"col {j} out of range for {self._ncols} cols")
        self._entries[(i, j)] = float(value)

    def __getitem__(self, key: tuple[int, int]) -> float:
        return self._entries.get((int(key[0]), int(key[1])), 0.0)

    def set_value(self, i: int, j: int, value: float) -> None:
        self[i, j] = value

    def add_value(self, i: int, j: int, value: float) -> None:
        self._entries[(int(i), int(j))] = self._entries.get((int(i), int(j)), 0.0) + float(value)

    def set_row(self, i: int, cols, values) -> None:
        for j, v in zip(cols, values):
            self[i, j] = v

    def set_col(self, j: int, rows, values) -> None:
        for i, v in zip(rows, values):
            self[i, j] = v

    # -- properties -------------------------------------------------------

    @property
    def nnz(self) -> int:
        return len(self._entries)

    @property
    def nrows(self) -> int:
        if self._nrows is not None:
            return self._nrows
        return 1 + max((i for i, _ in self._entries), default=-1)

    @property
    def ncols(self) -> int:
        if self._ncols is not None:
            return self._ncols
        return 1 + max((j for _, j in self._entries), default=-1)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    # -- freezing ---------------------------------------------------------

    def todense(self, dtype=np.float64) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        for (i, j), v in self._entries.items():
            out[i, j] = v
        return out

    def tocsc(self, dtype=np.float64):
        """Freeze to Vanderbei-layout CSC arrays ``(A, iA, kA)``.

        ``A`` — nnz values, column-major; ``iA`` — row index of each value;
        ``kA`` — ``ncols+1`` column pointers into ``A``/``iA``.
        """
        m, n = self.shape
        items = sorted(self._entries.items(), key=lambda kv: (kv[0][1], kv[0][0]))
        nnz = len(items)
        a = np.empty(nnz, dtype=dtype)
        ia = np.empty(nnz, dtype=np.int64)
        ka = np.zeros(n + 1, dtype=np.int64)
        for idx, ((i, j), v) in enumerate(items):
            a[idx] = v
            ia[idx] = i
            ka[j + 1] += 1
        np.cumsum(ka, out=ka)
        return a, ia, ka

    def tocoo(self, dtype=np.float64):
        items = sorted(self._entries.items(), key=lambda kv: (kv[0][1], kv[0][0]))
        rows = np.array([i for (i, _), _ in items], dtype=np.int64)
        cols = np.array([j for (_, j), _ in items], dtype=np.int64)
        vals = np.array([v for _, v in items], dtype=dtype)
        return rows, cols, vals

    @classmethod
    def from_dense(cls, mat) -> "SparseMatrixBuilder":
        mat = np.asarray(mat)
        b = cls(*mat.shape)
        for i, j in zip(*np.nonzero(mat)):
            b[int(i), int(j)] = float(mat[i, j])
        return b

    @classmethod
    def from_csc(cls, a, ia, ka, nrows: int | None = None) -> "SparseMatrixBuilder":
        ka = np.asarray(ka)
        n = len(ka) - 1
        b = cls(nrows, n)
        for j in range(n):
            for p in range(int(ka[j]), int(ka[j + 1])):
                b[int(ia[p]), j] = float(a[p])
        return b

    def __repr__(self) -> str:
        return f"SparseMatrixBuilder(shape={self.shape}, nnz={self.nnz})"


def dense_to_csc(mat, dtype=np.float64):
    """Dense (m,n) → Vanderbei CSC arrays (A, iA, kA)."""
    return SparseMatrixBuilder.from_dense(mat).tocsc(dtype=dtype)


def csc_to_dense(a, ia, ka, nrows: int, dtype=np.float64) -> np.ndarray:
    n = len(ka) - 1
    out = np.zeros((nrows, n), dtype=dtype)
    for j in range(n):
        for p in range(int(ka[j]), int(ka[j + 1])):
            out[int(ia[p]), j] = a[p]
    return out
