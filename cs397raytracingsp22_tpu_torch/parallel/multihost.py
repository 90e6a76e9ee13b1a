"""Multi-process and multi-host rendering on torch.distributed.

Mirrors `cs397raytracingsp22_tpu/parallel/multihost.py`. Every process is
one rank with one device; all ranks run the same driver loop over one
("dp", "sp") mesh (parallel/sharding.py) and return the same image. A
chunk's only traffic is the all_reduce that assembles its per-sp sums; a
render adds one all_reduce of its segment counts at the end, and a resumed
render one broadcast of rank 0's checkpoint.

Launch, one process a card (NCCL):

    torchrun --nproc-per-node 4 -m cs397raytracingsp22_tpu_torch.cli SCENE --distributed --mesh 2x2

or on each host i of N, without torchrun:

    python -m cs397raytracingsp22_tpu_torch.cli SCENE --distributed \\
        --coordinator host0:29500 --num-processes N --process-id i

From Python: `initialize(...)`, then `render_to_image_multihost(scene,
n_sp=...)`. Under torchrun torch reads the group's address from the
environment (`env://`); this package itself reads no environment variable.

The JAX package's `replicate_to_global` and `shard_to_global` have no
counterpart: there is no global array here. Each rank compiles the scene
itself and slices its own pixel ids out of each chunk.
"""

from __future__ import annotations

import datetime
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cs397raytracingsp22_tpu_torch.models.scene import resolve_device
from cs397raytracingsp22_tpu_torch.parallel import sharding

# how long a collective waits for the other ranks before it fails: a rank
# that died must not leave the others waiting forever, and a chunk of a
# full-size frame, or the kernels' first build, takes far less
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> tuple[int, int]:
    """Join the process group of a multi-process render: (rank, world size).

    coordinator_address "host:port" of rank 0 (tcp://), with num_processes
    and process_id; without all three, torch reads them from the
    environment torchrun sets up (env://). device defaults to "cuda" (the
    rank's card: rank modulo the cards on the host, under NCCL), or "cpu".
    backend defaults to NCCL for a CUDA device and gloo for the CPU; gloo
    on CUDA tensors only when asked for (several ranks sharing one card,
    which NCCL refuses)."""
    if coordinator_address is None and (num_processes is not None or process_id is not None):
        # falling back to the environment would discard the caller's topology
        raise ValueError(
            "num_processes/process_id require coordinator_address (pass --coordinator "
            "host:port, or none of the three under torchrun)"
        )
    if coordinator_address is not None and (num_processes is None or process_id is None):
        raise ValueError("coordinator_address needs num_processes and process_id")
    device = resolve_device("cuda" if device is None else device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", timeout=PROCESS_GROUP_TIMEOUT)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=PROCESS_GROUP_TIMEOUT)
    if device.type == "cuda":
        if device.index is not None:
            torch.cuda.set_device(device)
        elif backend == "nccl":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now, for the coordinator of a
    group whose ranks all run on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_global_mesh(n_dp: Optional[int] = None, n_sp: int = 1):
    """A ("dp", "sp") mesh over every rank of every host: ranks are
    host-major, so the dp axis keeps each host's pixels on its own cards."""
    return sharding.make_device_mesh(n_dp=n_dp, n_sp=n_sp)


def _collective_device() -> torch.device:
    """NCCL moves CUDA tensors only; gloo moves CPU tensors everywhere."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_to_host(x: torch.Tensor) -> np.ndarray:
    """The whole array as numpy on every rank. Each rank passes x holding
    its own part and exact zeros elsewhere (the layout in which
    parallel/sharding.py assembles a chunk); the parts are summed over the
    ranks by one all_reduce (gloo has no all-gather of CUDA tensors), which
    changes no bit. Without a process group, x itself."""
    if dist.is_initialized():
        x = sharding.sum_over_ranks(x.clone())
    return x.cpu().numpy()


def broadcast_checkpoint(checkpoint_path: str, n_px: int, seed: int):
    """Rank 0's checkpoint on every rank: (accum float32 (n_px, 3) or None,
    spp_done, nee flag, -1 for a file written before the flag existed).

    Only rank 0 writes checkpoints (render.driver), so on hosts without a
    shared filesystem the other ranks must not read their own copy, absent
    or stale: a disagreeing spp_done gives the ranks different numbers of
    chunks, and the collectives deadlock. Rank 0 reads the file; `have`,
    spp_done and nee, then the accumulator, are broadcast from it."""
    from cs397raytracingsp22_tpu_torch.render import driver

    dev = _collective_device()
    head = torch.tensor([0, 0, -1], dtype=torch.int64, device=dev)
    accum = None
    if dist.get_rank() == 0:
        got = driver._load_checkpoint(checkpoint_path, n_px, seed)
        if got is not None:
            accum, spp_done, nee = got
            head = torch.tensor([1, spp_done, nee], dtype=torch.int64, device=dev)
    dist.broadcast(head, src=0)
    have, spp_done, nee = head.tolist()
    if not have:
        return None, 0, -1
    if accum is None:
        buf = torch.empty((n_px, 3), dtype=torch.float32, device=dev)
    else:
        buf = torch.from_numpy(accum).to(dev)
    dist.broadcast(buf, src=0)
    return buf.cpu().numpy(), spp_done, nee


def render_to_image_multihost(scene, n_sp: int = 1, seed: int = 0, **kw):
    """Full multi-host render over a mesh of every rank (n_sp of them per
    sp group): the driver's one loop (chunking, checkpoint, retry,
    progress). Every rank runs it and returns the same image."""
    from cs397raytracingsp22_tpu_torch.render.driver import render_to_image

    return render_to_image(scene, seed=seed, mesh=make_global_mesh(n_sp=n_sp), **kw)
