"""Checkpoint save and restore (counterpart of
dsf_tpu/training/checkpoints.py; ref: train_render.py:284-308, torch.save
of {'model', 'optimizer', 'epoch'}, with the finetune_dir warm start).

A checkpoint is a directory (``latest``, ``best``) holding one
``state.pt``: the net's state dict, the guarded optimizer's state (its
moment buffers and the guard's counters), ``step`` and ``epoch``.  A save
copies the tensors to the host, then writes the file on a background
thread, so the loop goes on while it serializes; ``wait_until_finished``
drains it, and every restore waits first.  A restore onto the card keeps
every tensor on the card.  In a world of ranks every rank calls ``save``
(the optimizer's state, and under ``n_fsdp`` > 1 the parameters, are
gathered whole from their pieces) and rank 0 alone writes, so a
checkpoint is world 1's; every rank restores (a sharded net cuts its
pieces from the host's copy).  The port does not read the JAX package's orbax
checkpoints: a JAX run reaches the port through ``Trainer.init_state``'s
``variables``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import torch

from dsf_tpu_torch.parallel import fsdp

FILE = "state.pt"
_pending: Optional[threading.Thread] = None
_error: Optional[BaseException] = None
_lock = threading.Lock()


def wait_until_finished() -> None:
    """Wait for the save in flight, and raise its error if it failed."""
    global _pending, _error
    with _lock:
        t, _pending = _pending, None
    if t is not None:
        t.join()
    if _error is not None:
        err, _error = _error, None
        raise err


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def save(path: str, trainer, state, epoch: int) -> None:
    """Write ``state`` after ``epoch`` to the checkpoint directory
    ``path`` (replacing it), in the background; a collective in a world of
    ranks, where rank 0 writes."""
    global _pending
    wait_until_finished()                  # at most one save in flight
    ckpt = {"net": fsdp.state_dict(state.net),
            **_host({"optimizer": state.optimizer.state_dict(),
                     "step": int(state.step), "epoch": int(epoch)})}
    if trainer.mesh.rank != 0:
        return

    def write():
        global _error
        try:
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, f"{FILE}.{os.getpid()}.tmp")
            torch.save(ckpt, tmp)
            os.replace(tmp, os.path.join(path, FILE))
        except BaseException as e:  # noqa: BLE001 - raised by wait_until_finished
            _error = e

    t = threading.Thread(target=write, daemon=False)
    with _lock:
        _pending = t
    t.start()


def _resolve(path: str) -> str:
    """A checkpoint directory, or a run directory, which resolves to its
    ``latest`` checkpoint (so ``--load_model <run dir>`` works)."""
    if (not os.path.exists(os.path.join(path, FILE))
            and os.path.isdir(os.path.join(path, "latest"))):
        return os.path.join(path, "latest")
    return path


def _load(path: str, device) -> Dict:
    wait_until_finished()                  # a save to ``path`` may be in flight
    return torch.load(os.path.join(_resolve(path), FILE),
                      map_location=device, weights_only=True)


def restore_variables(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The net's state dict alone, for serving (``InferenceEngine``
    takes it as ``variables``)."""
    return _load(path, device)["net"]


def check_net(path: str, net, sd) -> None:
    """Raise RuntimeError, naming the keys, unless the state dict ``sd``
    (read from ``path``) has every key of ``net``'s state dict at its
    shape and no other: a checkpoint of another net (a ResNet trunk of
    another depth, one stage for two) is refused before any tensor
    loads."""
    own = fsdp.shapes(net)
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = [f"{k} {tuple(sd[k].shape)} for {tuple(v)}"
              for k, v in own.items() if k in sd and sd[k].shape != v]
    if missing or unexpected or shapes:
        raise RuntimeError(
            f"checkpoint {path} does not fit the net: {len(missing)} keys "
            f"missing {missing[:6]}, {len(unexpected)} unexpected "
            f"{unexpected[:6]}, {len(shapes)} of another shape {shapes[:6]}")


def restore(path: str, trainer, state, weights_only: bool = False):
    """Restore into ``state`` (in place) -> (state, the epoch to start
    at).  With ``weights_only`` (the reference's finetune_dir warm start,
    train_render.py:138-145) only the net loads; the optimizer and the
    step restart.  A checkpoint that does not fit the net or the
    optimizer raises before anything loads (``check_net``)."""
    # a sharded net takes its pieces from the host's whole tensors
    sharded = fsdp.sharded(state.net) is not None
    ckpt = _load(path, "cpu" if sharded else trainer.device)
    check_net(path, state.net, ckpt["net"])
    if not weights_only:
        state.optimizer.check_state_dict(ckpt["optimizer"])
    fsdp.load_state_dict(state.net, ckpt["net"])
    if weights_only:
        return state, 0
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state, int(ckpt["epoch"]) + 1
