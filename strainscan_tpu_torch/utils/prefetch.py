"""Background-thread iterator prefetch.

The count hot loop is: host parse -> bitpack -> h2d -> device dispatch.
Dispatch is async but parse/pack are serial on the main thread; running
the producer a few items ahead overlaps host parsing with device compute
on the identify path.  The producer runs in a copy of the caller's
``contextvars`` context, taken at the call, so its spans
(``strainscan_tpu_torch.timing``) have the caller's span as parent."""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iter(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from ``it`` with a daemon thread keeping ``depth`` items
    ready, started at the first ``next()`` in a copy of this call's
    context.  Exceptions in the producer re-raise at the consumer."""
    return _prefetch(it, depth, contextvars.copy_context())


def _prefetch(it: Iterable[T], depth: int,
              ctx: contextvars.Context) -> Iterator[T]:
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

    t = threading.Thread(target=ctx.run, args=(fill,), daemon=True,
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
