"""Background-thread batch prefetching (``gotennet_tpu/data/prefetch.py``).

Collation is numpy and C++ on the host; this wrapper overlaps it with the
device's work: a daemon thread runs the loader and keeps a small queue of
ready batches ahead of the training loop.  The consumer's wait for the
next batch is the tracer's ``loader.wait`` span.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from gotennet_tpu_torch.utils import profiling

__all__ = ["prefetch"]

_SENTINEL = object()


class _ProducerError:
    """What the producer queues when the loader raised: the exception,
    re-raised in the consumer (a class of its own, so that no item the
    loader yields can be taken for it)."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


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
            q.put(_ProducerError(e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        with profiling.span("loader.wait"):
            item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, _ProducerError):
            raise item.error
        yield item
