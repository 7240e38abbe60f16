"""Background-thread iterator prefetch.

The count hot loop is: host parse -> bitpack -> h2d -> device dispatch.
Dispatch is async but parse/pack are serial on the main thread; running
the producer a few items ahead overlaps host parsing with device compute
on the identify path."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iter(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from ``it`` with a daemon thread keeping ``depth`` items
    ready.  Exceptions in the producer re-raise at the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    err: list = []

    def fill():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=fill, daemon=True,
                         name="strainscan-prefetch")
    t.start()
    while True:
        x = q.get()
        if x is _SENTINEL:
            break
        yield x
    t.join()
    if err:
        raise err[0]
