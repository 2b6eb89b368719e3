"""Meshes of ``(data, model)`` or ``(pod, data, model)`` axes (the port of
``repro.launch.mesh``, the part the sharding rules read).

* :func:`make_local_mesh` spans the ranks of the initialised
  ``torch.distributed`` process group: a ``DeviceMesh`` whose axis groups
  the collectives run over.
* :func:`make_production_mesh` is shape only: axis names and sizes, no
  ranks, so the rules can be evaluated for 256 or 512 chips in one
  process.

The rules read a mesh through :func:`axis_sizes`, which takes either.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no ranks behind them.  ``shape``
    maps name -> size, as a JAX mesh's does."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 ``(data, model)``, or 2 x 16 x 16 ``(pod, data, model)``."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` DeviceMesh over the ranks of the default process
    group (``data * model`` must equal the world size).  The port reads
    only its axis groups and coordinates, never DTensor placement, so the
    mesh's own device type is ``"cpu"`` whatever device the tensors are
    on (``distributed.collectives`` stages a CUDA tensor through the host
    under gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: torch.distributed is not "
                           "initialised")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"make_local_mesh: {data} x {model} != world size "
                         f"{world}")
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict[str, int]:
    """name -> size of a ``MeshShape``, a ``DeviceMesh`` or any object
    with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}
