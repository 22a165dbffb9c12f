"""Device meshes over the process group: the port of ``repro.launch.mesh``.

Functions only: importing this module starts no process group.

Mesh semantics:
  * ``data``  — FSDP/ZeRO-3 parameter sharding + batch data parallelism.
  * ``model`` — tensor parallelism (TP) + expert parallelism (EP).
  * ``pod``   — pod-level data parallelism; multi-pod meshes prepend it.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group's world, one rank a device, on the device type of
this rank's device (``cuda`` with NCCL on the card, ``cpu`` with gloo in
the tests; a gloo world's mesh keeps gloo on CUDA too). The caller
starts the group (``torch.distributed.init_process_group``; ``torchrun``
gives the address, world size and rank through the environment).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _build(shape: tuple, names: tuple, device_type: str | None):
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    # the mesh's groups take the world's backend: left to itself, a CUDA
    # mesh over a gloo world (ranks sharing one card) makes NCCL groups,
    # which cannot hold two ranks on one device
    override = None
    if dist.is_initialized() and dist.get_backend() == "gloo":
        override = dict.fromkeys(names, "gloo")
    return init_device_mesh(device_type, shape, mesh_dim_names=names,
                            backend_override=override)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod"
    first; the world must hold exactly its 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if _world() != need:
        raise ValueError(f"make_production_mesh: needs {need} ranks, the "
                         f"process group has {_world()}")
    return _build(shape, names, device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str | None = None):
    """A ("data", "model") mesh over the ranks of the process group (one
    rank, with no group started).

    ``data`` must divide the world size exactly (no rank is silently
    dropped); ``model`` is clamped to at least 1 and at most what the
    remaining ranks allow, and ``data * model`` must then be the world.
    """
    n = _world()
    if data < 1 or n % data != 0:
        raise ValueError(
            f"make_host_mesh: data={data} must be a positive divisor of the "
            f"device count ({n} device{'s' if n != 1 else ''} available); "
            f"got remainder {n % data if data >= 1 else data}")
    model = max(1, min(model, n // data))
    if data * model != n:
        raise ValueError(f"make_host_mesh: a ({data}, {model}) mesh leaves "
                         f"{n - data * model} of {n} ranks out")
    return _build((data, model), ("data", "model"), device_type)
