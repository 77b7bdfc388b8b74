"""Frequency x DoF device meshes for the Helmholtz sweep (counterpart of
mathaudio_tpu/parallel/mesh.py), and the collectives the port's sharded
routes share.

Mapping (one process per rank, one card per rank):
- the reference's ``Mesh(devices, ("freq", "dof"))`` -> a
  ``torch.distributed.device_mesh.DeviceMesh`` with the same axis names;
- ``shard_map`` over stacked ``(S, ...)`` leaves -> each rank takes its
  slice ``[mesh.get_local_rank(axis)]`` to its device; outputs the reference
  shards (``P(axis)``) are all-gathered, so every rank holds the reference's
  global ``(S, ...)`` shape; replicated outputs (``P()``) stay as they are;
- ``psum`` -> ``all_reduce_sum``, ``pmean`` -> the sum over the group's
  size, ``all_gather(tiled=True)`` -> ``all_gather_tiled``,
  ``axis_index`` -> ``axis_index``.

A mesh axis name passed as a solver's ``axis_name`` is resolved against the
mesh in use: the innermost ``with use_mesh(mesh):`` block (the sharded
routes of this package enter one); a process group is taken as it is.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_MESHES = []  # the meshes in use, innermost last


def sweep_mesh(n_devices: Optional[int] = None, dof_parallel: int = 1, *, device_type=None):
    """(freq x dof) DeviceMesh over the world's ranks. ``n_devices``, when
    given, must be the world size (a DeviceMesh spans every rank of the
    default process group, which must exist, or come from ``torchrun``'s
    environment). ``device_type`` is "cuda" (NCCL; raises without a GPU)
    unless the caller asks for "cpu" (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' (gloo) "
                           "to run the mesh on the CPU")
    world = dist.get_world_size() if dist.is_initialized() else None
    n = n_devices or world
    if n is None:
        raise RuntimeError("no process group: start the ranks with parallel.launch or torchrun")
    if n % dof_parallel:
        raise ValueError(f"{n} devices do not split into dof groups of {dof_parallel}")
    if world is not None and n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, not {world}")
    return init_device_mesh(device_type, (n // dof_parallel, dof_parallel),
                            mesh_dim_names=("freq", "dof"))


def shard_frequency_sweep(mesh, sweep_fn):
    """A (params, ks) sweep with ks split over 'freq' and its outputs
    gathered back in ks order on every rank; params as given. Each rank
    runs the whole solve on its contiguous chunk of ks, with no
    communication (the rayon frequency loop): ranks that share a 'freq'
    coordinate (the 'dof' axis) solve the same chunk. ``len(ks)`` must
    split evenly over the axis."""

    def sharded(params, ks):
        return run_split(mesh, "freq", ks, lambda local: sweep_fn(params, local), "frequencies")

    return sharded


def shard_room_params(mesh, params, dof_axis: bool = True):
    """RoomParams on the mesh's device, whole on every rank. The
    reference's placement of the RHS and ELL rows over 'dof' is a hint to
    XLA's partitioner and does not change results; torch has no such
    partitioner, so ``dof_axis`` changes nothing here. The DoF-parallel
    path is spmd.py's explicit row sharding (``build_sharded_system``,
    ``sharded_gmres_fn``)."""
    dev = mesh_device(mesh)
    return type(params)(**{k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                           for k, v in params._asdict().items()})


def pmean_convergence(values, axis_name: str = "freq"):
    """Mean of ``values`` across the ranks of the axis (a mesh axis name,
    resolved against the mesh in use, or a process group): the sum over
    the group, divided by its size (gloo has no AVG)."""
    group = axis_group(axis_name)
    values = torch.as_tensor(values)
    return all_reduce_sum(values, group) / dist.get_world_size(group)


# ---------------------------------------------------------------------------
# What shard_map gave the reference: axes, slices, and the collectives.


def axis_size(mesh, axis: str) -> int:
    """Ranks along a mesh axis (the reference's ``mesh.shape[axis]``)."""
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along a mesh axis (``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards: its current card on a cuda mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@contextlib.contextmanager
def use_mesh(mesh):
    """Resolve mesh axis names (a solver's ``axis_name``) against ``mesh``
    inside the block."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def axis_group(axis_name):
    """The process group of ``axis_name``: None stays None (no sharding),
    a mesh axis name resolves against the mesh in use, a process group is
    taken as it is."""
    if axis_name is None or not isinstance(axis_name, str):
        return axis_name
    if not _MESHES:
        raise ValueError(f"axis_name={axis_name!r} names a mesh axis, but no device mesh is in "
                         "use: call inside `with use_mesh(mesh):`, or pass a process group")
    return _MESHES[-1].get_group(axis_name)


def _real(t: torch.Tensor) -> torch.Tensor:
    """A contiguous real view of ``t`` for the wire (complex as re/im pairs,
    bool as uint8): not every backend carries complex or bool."""
    t = t.contiguous()
    if t.is_complex():
        return torch.view_as_real(t)
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _unreal(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(buf)
    return buf.to(torch.bool) if like.dtype == torch.bool else buf


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """psum: the sum of ``t`` over the group's ranks, on every rank (a new
    tensor; complex reduced as re/im pairs). Every rank receives the same
    bits, so decisions taken on the result agree across ranks."""
    out = t.clone()
    dist.all_reduce(_real(out) if out.is_complex() else out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_tiled(t: torch.Tensor, group) -> torch.Tensor:
    """all_gather(tiled=True): the ranks' ``t`` concatenated along dim 0 in
    group-rank order. NCCL gathers into one tensor; gloo (no
    all_gather_into_tensor) into a list that is concatenated."""
    size = dist.get_world_size(group)
    wire = _real(t)
    if dist.get_backend(group) == "nccl":
        out = wire.new_empty((size * wire.shape[0],) + tuple(wire.shape[1:]))
        dist.all_gather_into_tensor(out, wire, group=group)
    else:
        parts = [torch.empty_like(wire) for _ in range(size)]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts)
    return _unreal(out, t)


def run_split(mesh, axis: str, x, fn, what: str):
    """``fn`` on this rank's contiguous chunk of ``x``'s leading axis (on
    its device, inside ``use_mesh(mesh)``), its outputs all-gathered over
    the axis (``gather_outputs``): every rank returns the whole leading
    axis in ``x``'s order. ValueError when the axis does not split evenly
    (``what`` names its entries in the message)."""
    n = axis_size(mesh, axis)
    x = torch.as_tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} {what} do not split over {n} devices")
    local = x.reshape((n, -1) + tuple(x.shape[1:]))[axis_index(mesh, axis)]
    with use_mesh(mesh):
        out = fn(local.to(mesh_device(mesh)))
    return gather_outputs(out, mesh, axis)


def local_shard(stacked, mesh, axis: str) -> torch.Tensor:
    """This rank's slice of a stacked ``(S, ...)`` leaf, on its device."""
    return torch.as_tensor(stacked)[axis_index(mesh, axis)].to(mesh_device(mesh))


def gather_outputs(out, mesh, axis: str):
    """Outputs sharded along ``axis`` (a tensor, or a tuple or list of
    them), each all-gathered along dim 0 over the axis's group."""
    group = mesh.get_group(axis)
    if isinstance(out, torch.Tensor):
        return all_gather_tiled(out, group)
    parts = [all_gather_tiled(t, group) for t in out]
    return type(out)(*parts) if hasattr(out, "_fields") else type(out)(parts)
