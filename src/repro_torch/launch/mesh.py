"""Production mesh construction: the port's copy of ``repro/launch/mesh.py``.

FUNCTIONS, not module-level constants, so importing this module never
touches a process group: the dry-run sets up its fake group of 256 or 512
ranks first (``launch/dryrun.py``), a card's run sets up its own.  Each
returns a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, whose world size must equal the mesh's rank count.

The production layouts are the reference's: 16 × 16 = 256 ranks
("data", "model"), and two of them under a leading "pod" axis
(2 × 16 × 16 = 512).  A mesh is on ``cuda`` unless the caller names
another device type (the dry-run's fake group: ``"cpu"``).  Where the
dry-run needs a card's capacity it reads :data:`H100`: the NVIDIA H100
80GB HBM3's memory (the SXM part, at its 700 W power limit).
"""
from __future__ import annotations

from typing import Optional, Tuple

H100 = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
        "hbm_bytes": 80e9}


def _device_type(device_type: Optional[str]) -> str:
    return "cuda" if device_type is None else device_type


def mesh_from_shape(shape: Tuple[int, ...], axes: Tuple[str, ...],
                    device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (initialised by the caller)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_from_shape(shape, axes, device_type)


def make_host_mesh(model_parallel: int = 1, device_type: Optional[str] = None):
    """A ("data", "model") mesh over however many ranks the process group
    has (tests; one card gives (1, 1))."""
    import torch.distributed as dist
    n = dist.get_world_size()
    assert n % model_parallel == 0
    return mesh_from_shape((n // model_parallel, model_parallel),
                           ("data", "model"), device_type)


def scale_mesh_shape(n_devices: int, n_lanes: int):
    """(lane, client) factorisation for :func:`make_scale_mesh`: the lane
    axis takes the largest divisor of ``n_devices`` that is ≤ ``n_lanes``
    and the remaining factor shards the client axis.  One device
    degenerates to (1, 1)."""
    lane = 1
    for d in range(min(n_devices, max(n_lanes, 1)), 0, -1):
        if n_devices % d == 0:
            lane = d
            break
    return lane, n_devices // lane


def make_scale_mesh(n_lanes: int = 1, shape=None,
                    device_type: Optional[str] = None):
    """2-D ``(lane, client)`` mesh for the population engine over the
    process group's ranks; ``shape=(lane, client)`` overrides the
    automatic factorisation.  ``None`` when it would hold one rank (or no
    process group is set up): the caller runs the unsharded program."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = scale_mesh_shape(n, n_lanes)
    lane, client = shape
    if lane * client <= 1:
        return None
    return mesh_from_shape((lane, client), ("lane", "client"), device_type)
