"""Process-group start and device meshes (port of
open3d_tpu/parallel/multihost.py), and the collectives the sharded paths
use.

The JAX package starts `jax.distributed` and lays its devices out in a
`jax.sharding.Mesh`. The port runs one process a card under a launcher
(torchrun) and joins them in a `torch.distributed` process group; a mesh
is a `torch.distributed.device_mesh.DeviceMesh` over the group's ranks
whose `mesh_dim_names` are the JAX package's axis names ("fragments",
"edges", "points", "obs"). The JAX package's `mesh.shape[axis]` is
`_axis_size(mesh, axis)` here, the device's index along an axis
`mesh.get_local_rank(axis)`, and `psum` / `all_gather` over an axis are one
`dist.all_reduce` / `dist.all_gather` over `mesh.get_group(axis)`.

Backend: NCCL for a mesh on the card, gloo only when the caller names the
CPU; a group whose backend does not match the mesh's device is refused,
never worked around.

Usage on each process of a run started by `torchrun --nproc-per-node N`:
    from open3d_tpu_torch.parallel import multihost
    multihost.initialize()          # False off a launcher: one process
    mesh = multihost.make_mesh(("fragments",))
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from open3d_tpu_torch.core.platform import default_device


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Start the process group when running under a multi-process launcher.

    Resolution order: explicit args ("host:port", the process count, this
    process's rank) > the JAX package's variables (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) > torchrun's (MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK). The backend is NCCL on the card
    (`device`, default: the card; each process takes the card LOCAL_RANK
    names, else rank modulo the cards it sees) and gloo when `device` names
    the CPU. Returns True when a multi-process group runs (started here or
    before); False for the single-process case, where the mesh factories
    start a one-rank group themselves."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _env_int("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize: the coordinator address, the process count and this "
                         "process's rank are all needed")
    dev = default_device(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(_backend(dev), init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _ensure_group(dev: torch.device) -> None:
    """The process group the meshes span: the launcher's, else a one-rank
    group over an in-process store. Its backend must serve `dev`."""
    if not dist.is_initialized() and not initialize(device=dev):
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)
    backend = dist.get_backend()
    if backend != _backend(dev):
        raise ValueError(f"the process group runs {backend}; a mesh on {dev.type} needs "
                         f"{_backend(dev)}")


def _mesh_ranks(n_devices: Optional[int], devices, dev: torch.device) -> list:
    """The first `n_devices` (default: all) of the ranks `devices` (default:
    every rank of the group, started if need be)."""
    _ensure_group(dev)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    return ranks[:n_devices or len(ranks)]


def make_mesh(
    axis_names: Sequence[str] = ("fragments",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices=None,
    device=None,
) -> DeviceMesh:
    """A DeviceMesh over the ranks `devices` (default: every rank of the
    group, one card each), on `device`'s type (default: the card). With one
    axis every rank lands on it; with several, sizes must multiply to the
    rank count (pass axis_sizes, or the first axis absorbs everything).
    Every rank of the group calls this. Without a launcher or a group, a
    one-rank group is started first."""
    dev = default_device(device)
    ranks = _mesh_ranks(None, devices, dev)
    n = len(ranks)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if math.prod(axis_sizes) != n:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} do not multiply to {n} ranks")
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(tuple(axis_sizes)),
                      mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# The collectives of the sharded paths
# ---------------------------------------------------------------------------


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {mesh.mesh_dim_names}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _check_mesh(mesh, axis: str, dev: torch.device) -> None:
    """A caller's `mesh`: a DeviceMesh of `dev`'s type with the axis `axis`."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for tensors on {dev}")
    _axis_size(mesh, axis)


def _shard(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's contiguous block of x's rows (their count divides by
    the axis size): what shard_map hands a device for P(axis)."""
    n = x.shape[0] // _axis_size(mesh, axis)
    i = mesh.get_local_rank(axis)
    return x[i * n:(i + 1) * n]


def _psum(xs, mesh: DeviceMesh, axis: str):
    """The sum over `axis` of each tensor of `xs` (float32, any shapes):
    one all_reduce of their concatenation. Returns new tensors."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    out, k = [], 0
    for x in xs:
        out.append(flat[k:k + x.numel()].reshape(x.shape))
        k += x.numel()
    return out


def _all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The ranks' x concatenated along dim 0 in their order along `axis`
    (all_gather tiled). Booleans travel as uint8."""
    n = _axis_size(mesh, axis)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=mesh.get_group(axis))
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out
