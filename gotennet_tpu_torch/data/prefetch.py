"""Background-thread batch prefetching (``gotennet_tpu/data/prefetch.py``).

Collation is numpy and C++ on the host; this wrapper overlaps it with the
device's work: a daemon thread runs the loader and keeps a small queue of
ready batches ahead of the training loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

__all__ = ["prefetch"]

_SENTINEL = object()


def prefetch(loader: Iterable, buffer_size: int = 2) -> Iterator:
    """Iterate ``loader`` with up to ``buffer_size`` batches prepared
    ahead in a background thread.  Exceptions in the producer re-raise
    in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)

    def producer():
        try:
            for item in loader:
                q.put(item)
        except BaseException as e:  # surface producer errors
            q.put(("__error__", e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, tuple) and len(item) == 2 and \
                item[0] == "__error__":
            raise item[1]
        yield item
