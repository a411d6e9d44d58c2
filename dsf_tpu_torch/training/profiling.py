"""Profiling hooks for the training loop (counterpart of
dsf_tpu/training/profiling.py): a ``torch.profiler`` trace and a step
timer that waits for the device only when its value is read.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card, written to ``log_dir`` for TensorBoard or Perfetto."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling step times over the last ``window`` steps.  ``tick()`` after
    each step marks its end: a CUDA event on a card (``device`` of type
    cuda), else the host clock.  Reading ``times_ms``, ``mean_ms`` or
    ``fps`` waits for the last mark; ticking never does."""

    def __init__(self, window: int = 50, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._marks: collections.deque = collections.deque(maxlen=window + 1)

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._marks.append(e)
        else:
            self._marks.append(time.perf_counter())

    def start(self) -> None:
        self._marks.clear()
        self._mark()

    def tick(self) -> None:
        self._mark()

    @property
    def times_ms(self) -> list:
        marks = list(self._marks)
        if self.cuda:
            if marks:
                marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    @property
    def mean_ms(self) -> float:
        t = self.times_ms
        return sum(t) / max(len(t), 1)

    def fps(self, batch_size: int) -> float:
        m = self.mean_ms
        return batch_size / (m / 1e3) if m else 0.0
