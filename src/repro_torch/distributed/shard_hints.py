"""The device mesh and the local blocks of the tensor-parallel group step.

Port of ``repro/distributed/shard_hints.py``: :func:`set_mesh`,
:func:`get_mesh` and :func:`tp_axis` (``:33-43``, ``:138-149``), and the
local-block logic of ``shard_group_step_tp`` (``:152``). The mesh is a 2-D
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")``. JAX runs the group step under ``shard_map`` on global arrays;
here the constrained leaves are ``DTensor``\\ s, ``Shard(-1)`` on "model"
and ``Shard(0)`` or ``Replicate()`` on "data", and each rank updates its
local ``(B_local, p, n_local)`` block in place. The only collective of the
step is one all-reduce of the gram payload over the "model" group
(:func:`all_reduce_payload`, counted). The mesh is process-global state;
unset, the driver takes the unsharded routes.
"""

from __future__ import annotations

from typing import Optional

import torch

_MESH = None


def set_mesh(mesh) -> None:
    """Install (or, with ``None``, clear) the process-global mesh."""
    global _MESH
    if mesh is not None and "model" not in (mesh.mesh_dim_names or ()):
        raise ValueError("the mesh needs a 'model' dim (dims ('data', 'model'))")
    _MESH = mesh


def get_mesh():
    return _MESH


def tp_axis() -> Optional[tuple[str, int]]:
    """``("model", width)`` of the mesh dim the TP step splits n over, or
    ``None`` without a mesh or when that dim is narrower than 2."""
    if _MESH is None:
        return None
    width = _MESH.size(_MESH.mesh_dim_names.index("model"))
    return ("model", int(width)) if width >= 2 else None


def is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_block(t) -> torch.Tensor:
    """The rank's block of a constrained ``DTensor`` leaf (its local tensor,
    whose in-place updates are the DTensor's). Raises unless the leaf is
    split over its last dim on "model" and not over its matrix dims on
    any other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = t.device_mesh.mesh_dim_names
    last = t.ndim - 1
    for name, pl in zip(names, t.placements):
        dim = pl.dim % t.ndim if isinstance(pl, Shard) else None
        ok = (dim == last) if name == "model" else (
            isinstance(pl, Replicate) or (dim is not None and dim < t.ndim - 2))
        if not ok:
            raise ValueError(
                f"a TP leaf must be Shard(-1) on 'model' and Shard of a batch "
                f"dim or Replicate() elsewhere; got {tuple(t.placements)} on "
                f"{names} for shape {tuple(t.shape)}")
    return t.to_local()


def wrap_like(local: torch.Tensor, like):
    """``local`` as a DTensor with the mesh, placements and global shape of
    ``like`` (no collective)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def shard_columns(full: torch.Tensor, mesh, *, shard_batch: bool = False):
    """A ``DTensor`` of ``full`` (the same tensor on every rank), split
    over its last dim on "model" and, with ``shard_batch``, over its first
    dim on "data" (else replicated there), in ``torch.chunk``'s split, as
    ``distribute_tensor`` makes it, but without a collective: each rank
    slices its own block (gloo scatters no CUDA tensors)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = full
    placements = []
    for name in mesh.mesh_dim_names:
        k = mesh.get_local_rank(name)
        width = mesh.size(mesh.mesh_dim_names.index(name))
        if name == "model" or shard_batch:
            dim = full.ndim - 1 if name == "model" else 0
            chunks = torch.chunk(local, width, dim=dim)
            local = chunks[k] if k < len(chunks) else local.narrow(dim, 0, 0)
            placements.append(Shard(dim))
        else:
            placements.append(Replicate())
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def all_reduce_payload(payload: torch.Tensor) -> torch.Tensor:
    """Sum ``payload`` in place over the mesh's "model" group: the one
    collective of a TP group step. Counts its calls in ``.calls``."""
    import torch.distributed as dist

    dist.all_reduce(payload, op=dist.ReduceOp.SUM,
                    group=_MESH.get_group("model"))
    all_reduce_payload.calls += 1
    return payload


all_reduce_payload.calls = 0
