"""Async session I/O: one bounded-queue writer thread.

The session pool must never stall intake on disk: decision records (the
JSONL sink) and checkpoint writes are enqueued here and performed by a
single background thread, in submission order.  The queue is BOUNDED:
when the writer falls behind by ``maxsize`` items, ``submit`` blocks
(backpressure, not unbounded memory).  ``close`` drains the queue, joins
the thread, and raises the first exception the worker hit (an I/O error
is never swallowed by the background thread).
"""

from __future__ import annotations

import queue
import threading

_STOP = object()


class AsyncWriter:
    """A single worker thread draining a bounded queue of callables.

    ``submit(fn, *args, **kwargs)`` enqueues one unit of I/O; ``flush()``
    blocks until everything enqueued so far has run; ``close()`` drains
    and joins.  The first exception raised by an enqueued callable is
    raised at the next ``submit`` / ``flush`` / ``close`` call, and the
    callables after it are skipped: callers see failures at the API
    boundary, in order, and never lose them.  As a context manager it
    closes on exit.
    """

    def __init__(self, maxsize: int = 256):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._exc: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="service-writer")
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                fn, args, kwargs = item
                if self._exc is None:       # fail-stop: skip after an error
                    try:
                        fn(*args, **kwargs)
                    except BaseException as e:
                        self._exc = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, fn, *args, **kwargs):
        """Enqueue ``fn(*args, **kwargs)``; blocks while the queue is full
        (bounded backpressure)."""
        if self._closed:
            raise RuntimeError("writer is closed")
        self._check()
        self._q.put((fn, args, kwargs))

    def flush(self):
        """Block until every enqueued callable has run."""
        self._q.join()
        self._check()

    @property
    def depth(self) -> int:
        """Items currently enqueued (approximate)."""
        return self._q.qsize()

    def close(self):
        """Drain, stop the worker, join, and raise any pending error.
        Idempotent."""
        if self._closed:
            self._thread.join()
            self._check()
            return
        self._closed = True
        self._q.put(_STOP)
        self._q.join()
        self._thread.join()
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
