"""Tracing and timing.

Counterpart of ``ctc_asr_tpu/utils/profiling.py``: ``trace`` /
``maybe_trace`` capture a ``torch.profiler`` trace of the enclosed block
(host activity, and the device's kernels and copies where CUDA is
present) and write it as a Chrome trace (``chrome://tracing``, Perfetto)
under the given directory; ``train.profile_dir`` wraps the train loop in
it, so set it for a short run (``--max-steps``). ``time_fn`` is the
simple wall timing of a callable with the device synchronised. The
reference's roofline helpers are not carried over: they hold another
accelerator's peak rates, and ``chip_smoke.py`` computes each kernel's
bound on the H100 from the shapes it runs.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


def time_fn(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Simple wall timing of ``fn(*args)`` (seconds/call): the device is
    synchronised after the warm-up and after the timed calls."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    for _ in range(warmup):
        fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters
