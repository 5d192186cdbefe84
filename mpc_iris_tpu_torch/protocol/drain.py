"""Graceful-drain support for the serving roles (SPEC section 5; copy of
``mpc_iris_tpu/protocol/drain.py``).

The reference leaves clean shutdown as TODOs (src/main.rs:449, 631, 641) —
a signal kills the process mid-reply and the peer sees a torn stream. Here
every server can DRAIN: stop accepting new connections, let in-flight
requests finish under a grace deadline, then exit; if the grace expires the
remaining connections are force-aborted so shutdown is bounded. The CLI
roles wire this to SIGTERM/SIGINT (second signal force-quits).

The authoritative "every connection finished" wait is the event loop's own
``Server.wait_closed()`` ON PYTHON >=3.12.1, whose semantics are: return
once every accepted connection has detached — including connections the
listener accepted moments before closing whose handler has not started yet,
which a handler-side counter would race past. On 3.10/3.11 ``wait_closed()``
returns as soon as the *listener* socket closes (bpo gh-79033, fixed in
3.12.1), which would report "drained clean" with replies still streaming —
so there drain falls back to polling the :class:`ConnectionTracker` (after
one loop turn, letting already-accepted handlers register). Handlers always
close their writer when done, so connections never outlive their reply.

The fallback is BEST-EFFORT: a connection accepted moments before the
listener closed whose handler has not yet registered (e.g. mid-TLS
handshake) can slip past the settle window and have its reply torn after
drain reports clean. Guaranteed-clean drains therefore require
Python >= 3.12.1; earlier interpreters get the documented best effort.
"""

from __future__ import annotations

import asyncio
import sys
import time

# Server.wait_closed() only waits for in-flight connections from 3.12.1 on
# (gh-79033 / gh-104344). Before that it is listener-close only.
_WAIT_CLOSED_TRACKS_CONNECTIONS = sys.version_info >= (3, 12, 1)


class ConnectionTracker:
    """Registers each live connection's writer so a draining server can
    force-abort whatever outlived the grace deadline. The wrapper never
    REFUSES a connection: anything the listener accepted before it closed
    deserves its reply; aborting is an explicit, logged last resort."""

    def __init__(self) -> None:
        self._writers: set[asyncio.StreamWriter] = set()

    @property
    def active(self) -> int:
        return len(self._writers)

    def wrap(self, handler):
        async def tracked(reader, writer):
            self._writers.add(writer)
            try:
                await handler(reader, writer)
            finally:
                self._writers.discard(writer)

        return tracked

    def abort_all(self) -> int:
        """Hard-close every tracked connection (RST, no flush). Returns the
        number aborted. In-flight handlers see connection errors on their
        next read/write and unwind through their normal cleanup."""
        n = 0
        for w in list(self._writers):
            transport = w.transport
            if transport is not None:
                transport.abort()
                n += 1
        return n


async def drain_server(server: asyncio.AbstractServer | None,
                       grace: float | None = None,
                       tracker: ConnectionTracker | None = None) -> bool:
    """Stop accepting and wait up to `grace` seconds for every accepted
    connection to finish. True = drained clean; False = deadline expired
    with connections still open (caller should abort_all + close).

    `tracker` is required for correct draining on Python < 3.12.1, where
    ``Server.wait_closed()`` does not wait for in-flight connections (see
    module docstring); there the wait polls ``tracker.active`` instead."""
    if server is None:
        return True
    server.close()
    if _WAIT_CLOSED_TRACKS_CONNECTIONS:
        try:
            await asyncio.wait_for(server.wait_closed(), grace)
            return True
        except asyncio.TimeoutError:
            return False
    # Pre-3.12.1 fallback: wait_closed() is listener-close only (and is NOT
    # awaited here — under the >=3.12.1 semantics this code path can still
    # be reached in tests, where it would block on in-flight connections).
    # Handlers register with the tracker only once they START, which for an
    # accepted-but-mid-TLS-handshake connection is several loop turns plus a
    # network round trip away — so after the listener closes, hold a short
    # SETTLE window during which the tracker must stay at zero before
    # reporting clean (shrinks, but cannot fully close, the registration
    # race; Python >= 3.12.1's wait_closed() is the airtight path).
    if tracker is None:
        # No tracker: in-flight connections are unobservable on this
        # Python; one extra turn is the best available effort.
        await asyncio.sleep(0)
        return True
    deadline = None if grace is None else time.monotonic() + grace
    settle_for = 0.25 if grace is None else min(0.25, grace)
    zero_since = None
    while True:
        now = time.monotonic()
        if tracker.active:
            zero_since = None
            if deadline is not None and now >= deadline:
                return False
        else:
            if zero_since is None:
                zero_since = now
            if now - zero_since >= settle_for:
                return True
            if deadline is not None and now >= deadline:
                return True  # zero at the deadline: nothing left to abort
        await asyncio.sleep(0.02)
