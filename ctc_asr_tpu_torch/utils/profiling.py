"""Tracing: named spans, counters and whole-block traces.

Counterpart of ``ctc_asr_tpu/utils/profiling.py``:

- ``span(name)`` opens a ``torch.profiler`` range (``record_function``)
  when a profiler is running on this thread, and otherwise returns a
  shared no-op context, so an untraced call pays one flag check. Each
  layer's span name is a module constant beside its code
  (``train.STEP_RANGE``, ``models.encoder.FRONTEND_RANGE``, ...); the
  spans of one step nest on one thread, and the backward of the
  autograd nodes a span created is tied to it by the nodes' sequence
  numbers, as the profiler records them.
- ``count(name, n)`` adds to a process-wide counter; ``counters()``
  returns a copy of them all. ``n`` may be a 0-d integer tensor, which
  is summed on its own device with no wait for it; ``counters()`` then
  fetches the sums.
- ``trace`` / ``maybe_trace`` capture a ``torch.profiler`` trace of the
  enclosed block (host activity, and the device's kernels and copies
  where CUDA is present) and write it as a Chrome trace
  (``chrome://tracing``, Perfetto) under the given directory;
  ``train.profile_dir`` wraps the train loop in it, so set it for a
  short run (``--max-steps``).

The reference's roofline helpers are not carried over: they hold
another accelerator's peak rates. The H100's bounds, and the readers of
these spans, are the benchmark's (``asrbench/flops.py``,
``asrbench/metrics/``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_counts: dict[str, int] = {}
_device_counts: dict[tuple, torch.Tensor] = {}   # (name, device) -> sum
_counts_lock = threading.Lock()


def span(name: str):
    """``record_function(name)`` while a profiler runs on this thread,
    else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-d integer tensor) to the process-wide
    counter ``name``."""
    with _counts_lock:
        if isinstance(n, torch.Tensor):
            key = (name, n.device)
            n = n.detach().long()
            held = _device_counts.get(key)
            _device_counts[key] = n.clone() if held is None else held + n
        else:
            _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter of the process (waits for the device's
    sums)."""
    with _counts_lock:
        out = dict(_counts)
        for (name, _dev), v in _device_counts.items():
            out[name] = out.get(name, 0) + int(v)
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace for the enclosed block and write
    ``<log_dir>/trace_<pid>_<ms since the epoch>.json``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def maybe_trace(log_dir: str):
    """trace(log_dir) when non-empty, else a no-op context."""
    return trace(log_dir) if log_dir else contextlib.nullcontext()
