"""The loader's side of the feed: a worker thread makes the stream's
batches ``depth`` ahead as contiguous arrays, as the port's
``data.DataLoader`` prefetches its padded batches in threads, so that
making the traffic runs beside the port and not in series with it."""

from __future__ import annotations

import queue
import threading

import numpy as np


class Prefetch:
    """Iterate batches ``first``, ``first + 1``, ... of ``stream``;
    ``close`` stops and joins the worker."""

    def __init__(self, stream, first: int = 0, depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.worker = threading.Thread(target=self._work, args=(first,),
                                       daemon=True)
        self.worker.start()

    def _put(self, item) -> None:
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _work(self, j: int) -> None:
        try:
            while not self.stop.is_set():
                b = self.stream.batch(j)
                b.samples = np.ascontiguousarray(b.samples)
                self._put(b)
                j += 1
        except Exception as exc:     # handed to the consumer, which raises
            self._put(exc)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self.stop.set()
        while self.worker.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.worker.join()
