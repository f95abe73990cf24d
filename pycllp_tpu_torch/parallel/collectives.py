"""Meshes and collectives of the port's parallel layer.

The reference runs one process over a JAX ``Mesh`` and binds its
collectives to a named axis inside ``shard_map``.  The port runs one
process per device on a ``torch.distributed`` process group, and a mesh
is a 1-D :class:`torch.distributed.device_mesh.DeviceMesh` whose one
dimension is named ``"scenario"`` or ``"model"``.  The collectives map
one to one:

==================  ===========================================
reference           port (this module)
==================  ===========================================
``lax.psum``        :func:`psum` — ``all_reduce(SUM)``
``lax.pmin/pmax``   :func:`pmin` / :func:`pmax` — ``all_reduce(MIN/MAX)``
``lax.all_gather``  :func:`all_gather` — ``all_gather`` (list form)
``lax.axis_index``  ``mesh.get_local_rank()`` — the rank in the mesh
==================  ===========================================

With no process group a :class:`LocalMesh` of size 1 takes the mesh's
place, and every collective on it is the identity (the reference's mesh
of one device).

Backends: NCCL runs the collectives on the rank's CUDA device.  Gloo runs
them on host buffers, so a CUDA tensor given to a gloo group is copied to
the host and back — here, in :func:`_run`, and nowhere else.  Two ranks
that share one card must use gloo (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = [
    "LocalMesh",
    "make_mesh",
    "psum",
    "pmin",
    "pmax",
    "all_gather",
]


@dataclass(frozen=True)
class LocalMesh:
    """A mesh of one device with no process group: every collective on it
    is the identity.  Answers the :class:`DeviceMesh` calls this package
    makes (``size``, ``get_local_rank``, ``get_group``, ``mesh_dim_names``)."""

    axis: str

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return (self.axis,)

    def size(self) -> int:
        return 1

    def get_local_rank(self) -> int:
        return 0

    def get_group(self):
        return None


def make_mesh(n_devices: int | None, axis: str):
    """1-D mesh named ``axis`` over every rank of the default group.

    Without a process group (or with ``n_devices=1``) a :class:`LocalMesh`:
    each rank then solves alone.  A mesh over some but not all ranks is
    refused: every rank of the group is one device of the mesh.  Every
    rank of the group calls this together.
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs a process group "
                "(pycllp_tpu_torch.parallel.initialize)"
            )
        return LocalMesh(axis)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n == 1 and world > 1:
        return LocalMesh(axis)
    if n != world:
        raise ValueError(f"a mesh spans one rank or all {world} ranks of the group, not {n}")
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's device type follows the backend: NCCL groups hold CUDA
    # tensors, gloo groups host tensors (see _run for CUDA tensors on gloo)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def _run(collective, t: torch.Tensor, group) -> torch.Tensor:
    """Run ``collective(buffer)`` on a private copy of ``t`` and return it.

    On a gloo group a CUDA tensor goes to the host for the collective and
    comes back to its device after it: gloo's collectives work on host
    buffers.  This is the one place the port moves a tensor between the
    card and the host for a collective.
    """
    stage = t.is_cuda and dist.get_backend(group) == "gloo"
    buf = t.detach().to("cpu", copy=True) if stage else t.detach().clone(
        memory_format=torch.contiguous_format)
    out = collective(buf)
    return out.to(t.device) if stage else out


def _all_reduce(t: torch.Tensor, mesh, op) -> torch.Tensor:
    group = mesh.get_group()
    if group is None:
        return t

    def reduce(buf):
        dist.all_reduce(buf, op=op, group=group)
        return buf

    return _run(reduce, t, group)


def psum(t: torch.Tensor, mesh) -> torch.Tensor:
    return _all_reduce(t, mesh, dist.ReduceOp.SUM)


def pmin(t: torch.Tensor, mesh) -> torch.Tensor:
    return _all_reduce(t, mesh, dist.ReduceOp.MIN)


def pmax(t: torch.Tensor, mesh) -> torch.Tensor:
    return _all_reduce(t, mesh, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim``, in rank order
    (``lax.all_gather(..., tiled=True)``).  The list form of
    ``dist.all_gather``: every torch version this port supports has it."""
    group = mesh.get_group()
    if group is None:
        return t

    def gather(buf):
        parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts, dim=dim)

    return _run(gather, t, group)
