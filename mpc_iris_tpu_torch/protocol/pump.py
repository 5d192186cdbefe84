"""Thread->asyncio streaming pump with cancellation (copy of
``mpc_iris_tpu/protocol/pump.py``).

Device-compute generators run in worker threads feeding bounded asyncio queues
(the reference's spawn_blocking + mpsc pipelines). A naive
``run_coroutine_threadsafe(q.put(..)).result()`` deadlocks the worker forever
if the consumer goes away (client disconnect, early truncation break, decode
error) — the queue stays full and the thread pins the engine stream and its
device buffers. The pump polls a stop event so abandoned workers exit promptly.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading


def put_blocking(queue: asyncio.Queue, item, loop, stop: threading.Event) -> bool:
    """Blocking put from a worker thread; returns False if cancelled/dead."""
    coro = queue.put(item)
    try:
        fut = asyncio.run_coroutine_threadsafe(coro, loop)
    except RuntimeError:  # loop already closed
        coro.close()  # retire the un-awaited coroutine quietly
        return False
    idle_polls = 0
    while True:
        try:
            fut.result(timeout=0.25)
            return True
        except concurrent.futures.TimeoutError:
            # A dead loop leaves fut unresolved forever: closed() is the
            # clean signal; a loop that simply STOPPED running (thread
            # returned without close()) gets a patience window — transient
            # not-running gaps between run_until_complete calls must not
            # trip it, but after ~10 s the loop is not coming back in this
            # architecture (serving loops run until process exit).
            idle_polls = 0 if loop.is_running() else idle_polls + 1
            if loop.is_closed() or idle_polls >= 40:
                # The callback scheduled by run_coroutine_threadsafe will
                # never execute: retire the queue.put coroutine (else it is
                # GC'd un-awaited — a RuntimeWarning) and stop spinning.
                fut.cancel()
                try:
                    coro.close()
                except RuntimeError:
                    pass  # a task claimed it before the loop died
                return False
            if stop.is_set():
                fut.cancel()
                return False
        except Exception:
            return False


class StreamPump:
    """Run a generator in a worker thread feeding a bounded queue.

    Ends the stream with ``None``; forwards generator exceptions as items.
    ``close()`` releases a blocked worker and drains the queue.
    """

    def __init__(self, gen, loop, maxsize: int = 4):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._loop = loop

        def run():
            try:
                for item in gen:
                    if not put_blocking(self.queue, item, loop, self._stop):
                        return
                put_blocking(self.queue, None, loop, self._stop)
            except Exception as e:
                put_blocking(self.queue, e, loop, self._stop)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    async def next_item(self):
        item = await self.queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        """Unblock and retire the worker (idempotent)."""
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except asyncio.QueueEmpty:
            pass
