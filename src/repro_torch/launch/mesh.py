"""Production mesh builders and mesh-geometry helpers, the twins of
``repro.launch.mesh``, as ``torch.distributed`` ``DeviceMesh``es.

A mesh's ranks are processes of the default process group: one rank a
device.  The production meshes need a group of 256 (``(16, 16)``, axes
``data, model``) or 512 ranks (``(2, 16, 16)``, ``pod, data, model``):
the dry run (``launch/dryrun.py``) builds them under torch's ``fake``
process group, one process standing for every rank.  A mesh is on the
card unless it is asked for on the CPU (``device="cpu"``), as every
entry point of the port: on one card it is ``(1, 1)``, one NCCL rank
(:func:`ensure_process_group`); a launcher fleet (``launch/launcher.py
--processes K``) whose workers each own a GPU is K NCCL ranks, and one
whose workers share a GPU is K gloo ranks, whose meshes are on the CPU.

Functions here never create a mesh at import.  ``mesh_geometry`` is the
device-free ``((name, size), ...)`` spelling that
``repro_torch.core.resolve_mesh`` accepts back.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch.core.distributed import (
    CARD_BACKEND, cuda_collectives, resolve_device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ensure_process_group(device=None) -> None:
    """Join a one-rank process group when none exists: on the card
    (``device`` None, ``RuntimeError`` without one, or CUDA) NCCL beside
    gloo, on ``device="cpu"`` gloo; a group that exists is kept."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    dist.init_process_group(
        CARD_BACKEND if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)


def mesh_device_type() -> str:
    """The device type of the default group's meshes: ``cuda`` under
    NCCL, ``cpu`` otherwise (gloo, fake)."""
    return "cuda" if cuda_collectives() else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(data: int | None = None, model: int = 1,
                   device=None) -> DeviceMesh:
    """A (data, model) mesh over the default group's ranks on ``device``
    (None: the card, ``RuntimeError`` without one; ``"cpu"``: the CPU),
    a one-rank group joined when there is none; ``data`` defaults to
    every rank the model axis leaves.  ``ValueError`` when the group has
    too few ranks, or for a mesh on the card over a gloo group."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data < 1 or data * model != n:
        raise ValueError(
            f"a (data={data}, model={model}) mesh needs {max(data, 1) * model}"
            f" ranks; the process group has {n} (run it as a fleet: python "
            f"-m repro_torch.launch.launcher --processes "
            f"{max(data, 1) * model} -- python ...)")
    if dev.type == "cuda" and not cuda_collectives():
        raise ValueError(
            "a mesh on the card needs an NCCL group, and this one is gloo: "
            "its ranks share one GPU (NCCL takes no two ranks on one GPU); "
            "pass device='cpu' for a mesh on the CPU")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def _shape(mesh) -> dict:
    """``{axis: size}`` of a DeviceMesh or of such a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch/population dimension."""
    shape = _shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def data_shards(mesh) -> int:
    shape = _shape(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= shape[a]
    return n


def mesh_geometry(mesh) -> tuple[tuple[str, int], ...]:
    """The mesh's geometry as ``((name, size), ...)`` pairs, the
    device-free spelling ``repro_torch.core.resolve_mesh`` accepts back
    (equal to its ``MeshGeometry``'s pairs)."""
    if hasattr(mesh, "axis_names") and hasattr(mesh, "sizes"):
        return tuple((str(n), int(s))
                     for n, s in zip(mesh.axis_names, mesh.sizes))
    return tuple((str(n), int(s)) for n, s in _shape(mesh).items())


def spans_processes(mesh: DeviceMesh) -> bool:
    """True when the mesh holds a rank other than this process's (a
    launcher fleet's mesh)."""
    me = dist.get_rank()
    return any(int(r) != me for r in mesh.mesh.flatten().tolist())


def replicate_to_mesh(x: torch.Tensor, mesh: DeviceMesh):
    """``x`` as a DTensor replicated over every mesh dimension: each
    rank's (identical) host copy placed on its own device."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return distribute_tensor(x.to(dev), mesh,
                             [Replicate()] * mesh.ndim)
