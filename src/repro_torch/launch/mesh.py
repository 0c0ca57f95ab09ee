"""Mesh construction over ``torch.distributed``. Counterpart of
``repro/launch/mesh.py``.

``make_production_mesh`` is a function, not a module constant, so
importing this module touches no process group. Single pod: (data=16,
model=16) = 256 ranks; multi-pod adds a leading "pod" axis: (pod=2,
data=16, model=16) = 512 ranks. ``REPRO_TEST_MESH="2x4"`` shrinks the
(data, model) part, as in the reference.

Ranks start from the usual environment, as ``torchrun`` sets it
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; the address
defaults to ``127.0.0.1``). The backend is the caller's choice, never
guessed: ``"nccl"`` when each rank has a card of its own, ``"gloo"`` when
ranks share a card or run on the CPU (the collectives then stage CUDA
tensors through host memory, ``distributed/collectives.py``). Each mesh
logs one ``mesh`` line with its backend, axes and ranks.

Roofline denominators are the H100 figures ``chip_smoke.py`` keeps
(``PEAK_BYTES_PER_S`` and the peak rates beside it); the reference's v5e
constants have no counterpart here.
"""
from __future__ import annotations

import json
import os

BACKENDS = ("nccl", "gloo")


def init_process_group(backend: str, rank: int = None,
                       world_size: int = None, addr: str = None,
                       port: int = None) -> None:
    """Join the default process group over TCP at ``addr:port``; each
    argument left out is read from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Under NCCL each
    rank takes card ``LOCAL_RANK`` (default: its rank). A no-op when the
    group exists already."""
    import torch
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if dist.is_initialized():
        return
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    addr = env.get("MASTER_ADDR", "127.0.0.1") if addr is None else addr
    port = int(env.get("MASTER_PORT", 29500)) if port is None else port
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world_size)


def make_mesh(shape, axes, backend: str = "gloo", device_type: str = None):
    """A ``DeviceMesh`` of ``shape`` over the default group (joined from
    the environment if need be, with ``backend``), named ``axes``.
    ``device_type`` defaults to ``"cuda"`` under NCCL, else ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    init_process_group(backend)
    backend = dist.get_backend()
    if device_type is None:
        device_type = "cuda" if backend == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
    print("mesh", json.dumps(dict(
        backend=backend, axes=list(axes), shape=list(shape),
        rank=dist.get_rank(), ranks=dist.get_world_size(),
        coordinate=mesh.get_coordinate())), flush=True)
    return mesh


def production_shape(multi_pod: bool = False):
    """((sizes), (axes)) of the production mesh, with the
    ``REPRO_TEST_MESH`` override."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    # REPRO_TEST_MESH="2x4" shrinks the mesh for CI smoke runs of the
    # dry-run machinery; production paths never set it.
    override = os.environ.get("REPRO_TEST_MESH")
    if override:
        dm = tuple(int(x) for x in override.split("x"))
        shape = ((2,) + dm) if multi_pod else dm
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl"):
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, backend)
