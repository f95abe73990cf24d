"""Row-sharded blocked Cholesky over a model mesh.

Counterpart of :mod:`pycllp_tpu.parallel.dchol`.  The column-sharded
big-LP path (:mod:`pycllp_tpu_torch.parallel.schur`) assembles the m×m
normal matrix with one all-reduce and by default factors it REPLICATED
on every rank; an LP whose m×m factor exceeds one device has no path that
way.  Here M's ROWS partition into P contiguous blocks of mb = m/P, one
per rank, and a right-looking blocked Cholesky runs as a P-step loop that
every rank executes in step:

    step k:  L_kk = chol(M_kk)            (every rank factors the (B, mb, mb)
                                           diagonal block, summed from its
                                           owner)
             P_i  = M_i[:, kcols]·L_kk⁻ᵀ (each rank, own rows; zero for
                                           finished rows i < k)
             panel = all_gather(P_i)      (ONE collective per step, (B, m, mb))
             M_i  -= P_i · panelᵀ         (the O(m³) trailing update, sharded)

Per-rank memory is O(B·mb·m) for the factor and O(B·m·mb) for the panel.
The solves run block by block: P small triangular solves chained by
all-reduce broadcasts of (B, mb) vectors.

Every rank of the mesh calls these functions together; the rank in the
mesh plays the reference's ``lax.axis_index``.  A diagonal block
that is not positive definite NaNs its lane (``lax.linalg.cholesky``'s
behaviour; ``torch.linalg.cholesky`` would raise).
"""

from __future__ import annotations

import torch

from pycllp_tpu_torch.parallel.collectives import all_gather, psum

__all__ = ["rowshard_cholesky", "rowshard_cholesky_solve", "cholesky_nan"]


def cholesky_nan(M: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor; a lane whose matrix is not positive
    definite comes back all NaN (as ``lax.linalg.cholesky``), never raises."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.nan, L)


def _owner_only(v: torch.Tensor, mine: bool) -> torch.Tensor:
    """``v`` on the rank that owns it, zeros elsewhere (for a psum-select)."""
    return v if mine else torch.zeros_like(v)


def rowshard_cholesky(Mw: torch.Tensor, mesh, n_blocks: int):
    """Factor a row-sharded SPD matrix: ``M = L·Lᵀ``, rows stay sharded.

    Parameters
    ----------
    Mw : (B, mb, m) — this rank's row block of the (B, m, m) matrix.
    mesh : the mesh whose ranks hold the row blocks, in rank order.
    n_blocks : the mesh size P (= m / mb).

    Returns ``(Lw, Lkks)``: ``Lw`` (B, mb, m) — this rank's rows of the
    lower factor; ``Lkks`` (P, B, mb, mb) — the diagonal blocks, the same
    on every rank (kept so the solves need no re-broadcast).
    """
    my = mesh.get_local_rank()
    B, mb, m = Mw.shape
    Lw = torch.zeros_like(Mw)
    kks = []
    for k in range(n_blocks):
        kcols = slice(k * mb, (k + 1) * mb)
        # the diagonal block, summed from its owner
        Lkk = cholesky_nan(psum(_owner_only(Mw[:, :, kcols], my == k), mesh))
        kks.append(Lkk)
        # panel piece for my rows: P_i = M_i[:, kcols] · L_kk⁻ᵀ (for i == k
        # this is L_kk itself; rows i < k are done and contribute zeros)
        if my >= k:
            Pi = torch.linalg.solve_triangular(Lkk.mT, Mw[:, :, kcols], upper=True, left=False)
        else:
            Pi = torch.zeros_like(Mw[:, :, kcols])
        panel = all_gather(Pi, mesh, dim=1)  # (B, m, mb), the whole panel column
        # trailing update of my rows (a no-op for finished rows: Pi == 0)
        Mw = Mw - Pi @ panel.mT
        if my >= k:
            Lw[:, :, kcols] = Pi
    return Lw, torch.stack(kks)


def rowshard_cholesky_solve(Lw: torch.Tensor, Lkks: torch.Tensor, r: torch.Tensor, mesh,
                            n_blocks: int) -> torch.Tensor:
    """Solve ``L·Lᵀ x = r`` for ``r`` (B, m), the same on every rank → x,
    the same on every rank.

    Block forward then backward substitution over the P row blocks; each
    step is one (B, mb, mb) triangular solve on every rank plus one
    all-reduce of a (B, mb) vector.
    """
    my = mesh.get_local_rank()
    B, mb, m = Lw.shape

    def tsolve(L, v, upper):
        A = L.mT if upper else L
        return torch.linalg.solve_triangular(A, v[..., None], upper=upper)[..., 0]

    # forward: y_k = L_kk⁻¹ (r_k − Σ_{j<k} L_kj y_j)  (the owner of block k
    # forms the partial sum from its own factor rows; psum broadcasts it)
    ys = []
    for k in range(n_blocks):
        acc = r[:, k * mb:(k + 1) * mb]
        if k:
            own = torch.einsum("bam,bm->ba", Lw[:, :, : k * mb], torch.cat(ys, dim=-1))
            acc = acc - psum(_owner_only(own, my == k), mesh)
        ys.append(tsolve(Lkks[k], acc, upper=False))

    # backward: x_k = L_kk⁻ᵀ (y_k − Σ_{i>k} L_ikᵀ x_i)  (every rank past
    # block k contributes its own rows' transpose-product)
    x = torch.zeros((B, m), dtype=Lw.dtype, device=Lw.device)
    for k in range(n_blocks - 1, -1, -1):
        kcols = slice(k * mb, (k + 1) * mb)
        xmine = x[:, my * mb:(my + 1) * mb]
        contrib = psum(_owner_only(torch.einsum("bar,ba->br", Lw[:, :, kcols], xmine), my > k),
                       mesh)
        x[:, kcols] = tsolve(Lkks[k], ys[k] - contrib, upper=True)
    return x
