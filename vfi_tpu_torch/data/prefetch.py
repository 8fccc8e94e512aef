"""Background batch prefetching (a copy of ``vfi_tpu/data/prefetch.py``,
plus :meth:`Prefetcher.close`).

Overlaps host-side clip decoding (GIL-free in the native C++ loader) with
device compute — the role DataLoader worker processes play in the reference
(train.py:40-41).  A bounded queue keeps `depth` batches in flight.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class Prefetcher:
    """Wrap a batch iterator with a background-thread bounded queue."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
                if self._closed:
                    break
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            self._err = e
        finally:
            if self._closed and hasattr(self._it, "close"):
                self._it.close()  # a generator's cleanup (a batch_iterator's thread pool)
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the background thread (after the item it is producing) and
        wait for it; an endless iterator's thread would otherwise wait on
        the full queue for the life of the process."""
        self._closed = True
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
