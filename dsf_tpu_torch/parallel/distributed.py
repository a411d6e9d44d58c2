"""Process start-up and per-rank data stripes (counterpart of
dsf_tpu/parallel/distributed.py).

One process drives one card.  ``torchrun --nproc-per-node N`` starts N
of them and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, the roles of the JAX package's
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``; ``initialize`` reads them.  Without them (or with
``WORLD_SIZE`` 1) a process is world 1 and nothing starts.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist


def initialize(device: Optional[Union[str, torch.device]] = None,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group the environment describes and return this
    rank's device.

    ``device`` None means the card: ``torch.cuda.set_device(LOCAL_RANK)``
    first, then NCCL; a rank without CUDA raises, it never moves to the
    CPU or to gloo.  ``device="cpu"`` joins over gloo (the tests).
    ``backend`` overrides the choice (gloo on the card runs two ranks on
    one GPU, which NCCL refuses).  With ``WORLD_SIZE`` unset or 1 nothing
    is joined, and a group the caller set up already is kept; either way
    the device is returned (``cuda`` resolved to the current card)."""
    from dsf_tpu_torch.device import resolve_device
    world_env = int(os.environ.get("WORLD_SIZE", "1"))
    cpu = device is not None and torch.device(device).type == "cpu"
    if dist.is_initialized() or world_env <= 1:
        return resolve_device(device)
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {rank}: CUDA is not available; a multi-GPU run needs "
                "one card a rank (device='cpu' joins over gloo on the CPU)")
        if device is not None and torch.device(device).index is not None:
            local = torch.device(device).index
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world_env)
    return dev


def rank() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of processes, 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_dataset_indices(n: int, batch_size: int, seed: int = 0,
                          rank: int = 0, world: int = 1) -> np.ndarray:
    """Per-rank epoch index stripes: every rank permutes ``n`` identically
    and takes its ``batch_size // world`` columns of each global batch, so
    the union covers each full batch exactly once (rows: batches)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    per = batch_size // world
    usable = (n // batch_size) * batch_size
    order = order[:usable].reshape(-1, batch_size)
    return order[:, rank * per:(rank + 1) * per]
