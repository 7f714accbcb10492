"""Background-thread batch prefetch for the training loops.

The port's copy of the JAX package's ``data/prefetch.py``: batch assembly
(bucketing, padding, tokenizer lookups; host work) runs in a daemon thread
a bounded depth ahead of the train loop, so it overlaps device compute
instead of serializing with it.

Exactness: the wrapped iterator is consumed in order, depth-bounded, and
worker exceptions re-raise in the consumer at the faulting position. A
consumer that stops early (``max_steps`` break) unblocks and terminates
the worker via the stop event in the generator's ``finally``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

__all__ = ["prefetch"]

_END = object()


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Yield items of ``it`` produced by a background thread, at most
    ``depth`` items ahead."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for x in it:
                if not _put(x):
                    return
        except BaseException as e:  # re-raise at the consumption point
            if _put(_END):
                _put(e)
            return
        if _put(_END):
            _put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is _END:
                err = q.get()
                if err is not None:
                    raise err
                return
            yield x
    finally:
        stop.set()
