"""Multi-process runtime: one process per device, on ``torch.distributed``.

Port of ``wrf_partmc_tpu/parallel/distributed.py``.  Every process runs
the same script:

    from wrf_partmc_tpu_torch.parallel import distributed as pdist
    pdist.init_from_env("cuda")     # False when single-process
    mesh = pdist.global_mesh()      # ('y', 'x') over all ranks
    model, state = entry.build(..., mesh=mesh, device=mesh.device)

Environment, set by the launcher (``python -m
wrf_partmc_tpu_torch.parallel.launch``), with the JAX package's names:

    WPMC_COORDINATOR   host:port of rank 0's store (absent: one process),
                       or a ``tcp://`` / ``file://`` init method
    WPMC_NUM_PROCS     the number of processes
    WPMC_PROC_ID       this process's rank

A ``cuda`` device runs NCCL on ``cuda:{rank % device_count}``, ``cpu``
runs gloo; both with an explicit timeout.  A ``cuda`` world that cannot
start NCCL raises: it never carries on with gloo or on the CPU.
"""

from __future__ import annotations

import datetime
import inspect
import os

import numpy as np
import torch
import torch.distributed as dist

from . import halo
from .mesh import Mesh, factor_2d, make_mesh

DEFAULT_TIMEOUT_S = 300.0


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("tcp://", "file://", "env://")):
        return coordinator
    return f"tcp://{coordinator}"


def init(coordinator: str, num_procs: int, proc_id: int, device="cuda",
         timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Start the default process group: NCCL for a ``cuda`` device (this
    rank on ``cuda:{proc_id % device_count}``), gloo for ``cpu``.  Returns
    this rank's device."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda world asked for, but no CUDA device is available")
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda world needs NCCL, which this torch lacks")
        dev = torch.device("cuda", proc_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    if "127.0.0.1" in coordinator or "localhost" in coordinator or \
            coordinator.startswith("file://"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # bind NCCL to the device at init, where torch can
    kw = ({"device_id": dev} if backend == "nccl" and "device_id" in
          inspect.signature(dist.init_process_group).parameters else {})
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=num_procs, rank=proc_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def init_from_env(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group from the ``WPMC_*`` variables.  Returns True
    when it did, False for a single process (no ``WPMC_COORDINATOR``)."""
    coord = os.environ.get("WPMC_COORDINATOR")
    if not coord:
        return False
    init(coord, int(os.environ["WPMC_NUM_PROCS"]), int(os.environ["WPMC_PROC_ID"]),
         device, timeout_s)
    return True


def shutdown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(shape=None, device=None) -> Mesh:
    """The ('y', 'x') mesh over every rank of the world (``factor_2d`` of
    the world size when ``shape`` is None)."""
    if shape is None:
        shape = factor_2d(dist.get_world_size())
    return make_mesh(shape, device=device)


def process_block(mesh: Mesh):
    """((y0, y1), (x0, x1)): the mesh rows and columns this process owns
    (one device per process: one position)."""
    return (mesh.iy, mesh.iy + 1), (mesh.ix, mesh.ix + 1)


def host_to_global(local_block, mesh: Mesh) -> torch.Tensor:
    """This process's block of a decomposed field (numpy or tensor) on its
    device: the block the other ranks' blocks complete."""
    return torch.as_tensor(np.asarray(local_block) if not torch.is_tensor(local_block)
                           else local_block, device=mesh.device)


def global_to_host(block: torch.Tensor) -> np.ndarray:
    """This process's block as numpy (inverse of :func:`host_to_global`)."""
    return block.detach().cpu().numpy()


def gather_field(block: torch.Tensor, mesh: Mesh | None, dims=None) -> torch.Tensor:
    """The whole field on every rank from each rank's block: one
    all-gather, the blocks placed by their mesh positions along the
    (y, x) axes ``dims`` (default: 0, 1 of a 2-D block, else 1, 2).
    ``mesh=None`` returns ``block``."""
    if mesh is None:
        return block
    ay, ax = dims if dims is not None else ((0, 1) if block.dim() == 2 else (1, 2))
    if ax != ay + 1:
        raise ValueError("gather_field: the y and x axes must be adjacent")
    parts = halo.all_gather(block, mesh)                  # [py*px, *block]
    lead, ny_l, nx_l, trail = block.shape[:ay], block.shape[ay], block.shape[ax], \
        block.shape[ax + 1:]
    g = parts.reshape(mesh.py, mesh.px, *block.shape)
    nl = len(lead)
    # [py, px, *lead, ny_l, nx_l, *trail] -> [*lead, py, ny_l, px, nx_l, *trail]
    perm = (*range(2, 2 + nl), 0, 2 + nl, 1, 3 + nl, *range(4 + nl, g.dim()))
    return g.permute(perm).reshape(*lead, mesh.py * ny_l, mesh.px * nx_l, *trail)
