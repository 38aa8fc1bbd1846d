"""Multi-process utilities on torch.distributed (counterpart of
`f5e_tts_tpu/parallel/multihost.py`).

reference equivalents: Accelerate process-group setup (trainer.py:63-68),
`split_between_processes` (eval_infer_batch.py:187), `wait_for_everyone`
barriers. One process per rank; the rank and the world size come from
torch.distributed once `initialize` has set the default group up.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _up() else 1


def process_index() -> int:
    return dist.get_rank() if _up() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """torch.distributed.init_process_group over `coordinator_address`
    ("host:port", or "tcp://host:port"); a no-op for one process. Left out,
    the three come from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). `backend` is the default group's; the mesh's groups
    pick their own (parallel/mesh.py: Mesh transport)."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or _up():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def local_device(device: str = "cuda") -> str:
    """This process's device: for "cuda" in a world of several processes,
    cuda:<LOCAL_RANK> (torchrun's; 0 when unset), made the current device;
    any other request as it is."""
    if device != "cuda" or process_count() == 1:
        return device
    index = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(index)
    return f"cuda:{index}"


def shutdown() -> None:
    """Tear the default group down (a no-op without one)."""
    if _up():
        dist.destroy_process_group()


def split_between_processes(items: Sequence, pad: bool = False) -> list:
    """This process's contiguous chunk of a work list (Accelerate semantics:
    the last process may get fewer; pad=True repeats the last item so every
    process gets equal work), by torch.distributed's rank and world size."""
    pc, pi = process_count(), process_index()
    per = -(-len(items) // pc)
    chunk = list(items[pi * per:(pi + 1) * per])
    if pad and chunk and len(chunk) < per:
        chunk += [chunk[-1]] * (per - len(chunk))
    return chunk


def barrier(name: str = "barrier") -> None:
    """Every process waits here for the others (wait_for_everyone); `name`
    labels the call as in the JAX package."""
    if process_count() > 1:
        dist.barrier()


def broadcast_from_host0(x: np.ndarray) -> np.ndarray:
    """Process 0's array on every process (same shape and dtype everywhere)."""
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).clone()
    dist.broadcast(t, src=0)
    return t.numpy()
