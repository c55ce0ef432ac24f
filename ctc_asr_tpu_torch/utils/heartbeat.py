"""Heartbeat logging / stall detection.

The port's own copy of ``ctc_asr_tpu/utils/heartbeat.py``. The recovery
model is checkpoint-restart, plus a lightweight heartbeat so a hung step (input starvation, device
wedge) is VISIBLE rather than silent: a daemon thread logs progress
periodically and warns when no step completes within ``stall_seconds``.
"""

from __future__ import annotations

import threading
import time


class Heartbeat:
    def __init__(self, interval_seconds: float = 60.0,
                 stall_seconds: float = 300.0, log_fn=print):
        self.interval = interval_seconds
        self.stall = stall_seconds
        self.log = log_fn
        self._last_step = -1
        self._last_beat = time.monotonic()
        self._last_progress = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self, step: int) -> None:
        """Call once per completed train step."""
        if step != self._last_step:
            self._last_step = step
            self._last_progress = time.monotonic()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            now = time.monotonic()
            idle = now - self._last_progress
            if idle > self.stall:
                self.log(f"[heartbeat] WARNING: no step progress for "
                         f"{idle:.0f}s (last step {self._last_step})",
                         flush=True)
            else:
                self.log(f"[heartbeat] alive at step {self._last_step} "
                         f"({idle:.0f}s since last step)", flush=True)

    def start(self) -> "Heartbeat":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
