"""Participant role: share-holding match server (reference src/main.rs:384-452;
copy of ``mpc_iris_tpu/protocol/participant.py``).

Holds one additive-share DB device-resident (via :class:`ShareEngine` or its sharded
variant), accepts one query per TCP connection, and streams the per-entry dot-share
records back while the next DB chunks are still computing on device.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque

import numpy as np

from mpc_iris_tpu_torch.protocol.drain import ConnectionTracker, drain_server
from mpc_iris_tpu_torch.protocol.pump import StreamPump
from mpc_iris_tpu_torch.protocol.wire import (
    batched_records_to_bytes,
    chain_query_bytes,
    read_batched_query,
    read_batched_records,
    read_chain_query,
    read_template_bytes,
    records_per_read,
    records_to_bytes,
)
from mpc_iris_tpu_torch.constants import BITS_BYTES

log = logging.getLogger("mpc_iris_tpu_torch.participant")


class _UpstreamFeed:
    """Prefetches the upstream chain's entry-groups CONCURRENTLY with this
    party's device compute (the chain analogue of the coordinator's
    gather-overlap, src/main.rs:560): a reader task pulls byte-budgeted
    slices into a small queue while the handler awaits its next device
    chunk, so network time hides behind compute at every hop."""

    def __init__(self, reader, b: int, budget: int, loop):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=2)
        self._leftover: np.ndarray | None = None
        self._eof = False
        self._task = loop.create_task(self._pump(reader, b, budget))

    async def _pump(self, reader, b: int, budget: int):
        try:
            while True:
                block, eof = await read_batched_records(reader, b, budget)
                if block.shape[0]:
                    await self._q.put(block)
                if eof or block.shape[0] < budget:
                    await self._q.put(None)
                    return
        except asyncio.CancelledError:
            raise
        except Exception as e:  # mid-chain reset etc.: surface via take()
            await self._q.put(e)

    async def take(self, n: int, timeout: float | None) -> np.ndarray:
        """Up to ``n`` entry-groups; fewer ONLY at upstream EOF. Raises
        asyncio.TimeoutError on a stalled upstream (``timeout`` seconds per
        queue wait) and propagates reader errors (e.g. a reset from an
        aborting chain above us)."""
        parts = []
        got = 0
        while got < n and not self._eof:
            if self._leftover is not None:
                blk = self._leftover
                self._leftover = None
            else:
                get = self._q.get()
                blk = await (asyncio.wait_for(get, timeout) if timeout
                             else get)
                if blk is None:
                    self._eof = True
                    break
                if isinstance(blk, Exception):
                    self._eof = True
                    raise blk
            take = min(n - got, blk.shape[0])
            parts.append(blk[:take])
            if take < blk.shape[0]:
                self._leftover = blk[take:]
            got += take
        if not parts:
            return np.zeros((0, 0, 0), dtype=np.uint16)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def close(self) -> None:
        self._task.cancel()


class ParticipantServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 1234,
                 wire: str = "reference", ssl_context=None, refresh=None,
                 read_timeout: float | None = None,
                 upstream_ssl_context=None,
                 upstream_timeout: float | None = None,
                 allowed_upstreams: set[str] | None = None):
        """engine: ShareEngine or ShardedShareEngine (anything with .stream).

        wire: "reference" = one raw template per connection (byte-compatible
        with the reference); "batched" = u32 count + B templates, entry-major
        B-group reply (this framework's batched extension); "chain" = batched
        plus chained reply aggregation (SPEC section 5.4): the request names
        this party's upstream chain, whose aggregated stream is read, added
        to this party's own dot shares (mod 2^16), and forwarded downstream
        as ONE stream — the coordinator's ingress stops scaling with the
        party count. Chain hops connect with ``upstream_ssl_context`` when
        given (a CLIENT context; independent of this server's TLS).
        ``upstream_timeout`` bounds each upstream read wait — a deadline
        DISTINCT from read_timeout, because an upstream slice legitimately
        takes device-compute time to arrive while a client's query bytes do
        not. ``allowed_upstreams`` (a set of "host:port") restricts which
        addresses a chain request may point this party at; None allows any
        (the reference's trusted-network model) — set it in untrusted
        networks, where an open relay is an SSRF primitive.

        ssl_context: optional `ssl.SSLContext` (tlsutil.server_context) —
        the wire inside the tunnel is unchanged.

        refresh: optional zero-arg callable run before each request is read —
        the DB-sync hook the reference leaves as a TODO (src/main.rs:415:
        "Sync from database and add to memmapped file" inside the accept
        loop). Typically cli.make_share_watcher(path, engine): stat the
        share file and engine.refresh() any appended rows. Called in a
        worker thread under a server-wide lock (concurrent connections
        sync once, not racily).

        read_timeout: deadline in seconds for receiving the complete query
        after a client connects. A connected-but-silent client otherwise
        pins its connection (and its refresh-lock turn) forever; on expiry
        the connection is logged and closed without computing anything
        (SPEC section 5). None (default) waits forever like the reference.
        """
        if wire not in ("reference", "batched", "chain"):
            raise ValueError(f"unknown wire mode {wire!r}")
        self.upstream_ssl_context = upstream_ssl_context
        self.upstream_timeout = upstream_timeout
        self.allowed_upstreams = allowed_upstreams
        self.engine = engine
        self.host = host
        self.port = port
        self.wire = wire
        self.ssl_context = ssl_context
        self.refresh = refresh
        self.read_timeout = read_timeout
        self._refresh_lock = asyncio.Lock()
        self._server: asyncio.AbstractServer | None = None
        self._tracker = ConnectionTracker()
        # Serving stats (observability parity+ with the reference's
        # indicatif progress lines, src/main.rs:437): monotonic counters +
        # a bounded per-request latency window; logged every `stats_every`
        # completed requests, readable any time via stats().
        self.served = 0
        self.failed = 0
        self.entries_sent = 0
        self.stats_every = 100
        self._lat_window: deque[float] = deque(maxlen=512)

    def stats(self) -> dict:
        """Serving counters + latency quantiles over the recent window."""
        lat = sorted(self._lat_window)
        q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0
        return {
            "served": self.served,
            "failed": self.failed,
            "entries_sent": self.entries_sent,
            "p50_s": q(0.50),
            "p95_s": q(0.95),
            "window": len(lat),
        }

    def _count_request(self, dt: float, entries: int) -> None:
        self.served += 1
        self.entries_sent += entries
        self._lat_window.append(dt)
        if self.stats_every and self.served % self.stats_every == 0:
            s = self.stats()
            log.info(
                "served %d requests (%d failed, %d entry-replies) — "
                "p50 %.3fs p95 %.3fs over the last %d",
                s["served"], s["failed"], s["entries_sent"],
                s["p50_s"], s["p95_s"], s["window"],
            )

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._tracker.wrap(self._handle), self.host, self.port,
            ssl=self.ssl_context,
        )
        sock = self._server.sockets[0].getsockname()
        log.info("participant listening on %s:%s", sock[0], sock[1])
        self.port = sock[1]
        return sock[0], sock[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def drain(self, grace: float | None = None) -> bool:
        """Graceful shutdown: stop accepting new connections, wait up to
        `grace` seconds for in-flight replies to finish streaming (SPEC §5;
        the reference's clean-shutdown TODO, src/main.rs:449). Returns False
        if the deadline expired with connections still open — call
        :meth:`abort_connections` then :meth:`close` to finish shutdown."""
        return await drain_server(self._server, grace, tracker=self._tracker)

    def abort_connections(self) -> int:
        """Hard-close every live connection (the post-grace force path)."""
        return self._tracker.abort_all()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        log.info("inbound from %s", peer)
        try:
            if self.refresh is not None:
                # Engine growth is append-only and in-flight streams capture
                # their chunk count at generator start, so syncing here can
                # not corrupt a concurrent reply (see ShareEngine.refresh).
                async with self._refresh_lock:
                    await asyncio.to_thread(self.refresh)
            upstream: list[str] = []
            if self.wire == "chain":
                read = read_chain_query(reader)
                if self.read_timeout:
                    read = asyncio.wait_for(read, self.read_timeout)
                qpat, qmsk, upstream = await read
            elif self.wire == "batched":
                read = read_batched_query(reader)
                if self.read_timeout:
                    read = asyncio.wait_for(read, self.read_timeout)
                qpat, qmsk = await read
            else:
                read = read_template_bytes(reader)
                if self.read_timeout:
                    read = asyncio.wait_for(read, self.read_timeout)
                raw = await read
                qpat = np.frombuffer(raw[:BITS_BYTES], dtype=np.uint8)[None]
                qmsk = np.frombuffer(raw[BITS_BYTES:], dtype=np.uint8)[None]
            batched = self.wire in ("batched", "chain")
            to_bytes = (
                batched_records_to_bytes if batched
                else lambda block: records_to_bytes(block[0])
            )

            # Device compute in a worker thread feeding a bounded queue (the
            # reference's spawn_blocking + mpsc pipeline, src/main.rs:423-434).
            # The pump is cancellable: a dropped client must not strand the
            # worker (and its device buffers) on a full queue forever.
            loop = asyncio.get_running_loop()
            # Batched wire: entry-major layout comes straight from the device,
            # so serialization is a straight copy (no host transpose).
            pump = StreamPump(
                self.engine.stream(qpat, qmsk, entry_major=batched), loop
            )
            up_writer = None
            feed = None
            t0 = time.monotonic()
            try:
                b = qpat.shape[0]
                budget = records_per_read(b)
                if upstream:
                    # Recursive chain assembly: this party's request to ITS
                    # upstream names everything before it in the chain. An
                    # unreachable or disallowed upstream ABORTS the downstream
                    # connection (RST, not clean EOF) so the failure
                    # propagates loudly instead of reading as a legitimately
                    # shorter scan.
                    if (self.allowed_upstreams is not None
                            and upstream[-1] not in self.allowed_upstreams):
                        log.error(
                            "chain request from %s names disallowed upstream "
                            "%s (allowed: %s) — aborting", peer, upstream[-1],
                            sorted(self.allowed_upstreams),
                        )
                        self.failed += 1
                        writer.transport.abort()
                        return
                    host, _, port = upstream[-1].rpartition(":")
                    try:
                        up_reader, up_writer = await asyncio.open_connection(
                            host, int(port), ssl=self.upstream_ssl_context
                        )
                    except OSError as e:
                        log.error("cannot reach upstream %s: %s — aborting "
                                  "the chain reply", upstream[-1], e)
                        self.failed += 1
                        writer.transport.abort()
                        return
                    up_writer.write(
                        chain_query_bytes(qpat, qmsk, upstream[:-1])
                    )
                    await up_writer.drain()
                    feed = _UpstreamFeed(up_reader, b, budget, loop)
                sent = 0
                truncated = False
                while not truncated:
                    item = await pump.next_item()
                    if item is None:
                        break
                    if feed is None:
                        writer.write(to_bytes(item))
                        await writer.drain()
                        sent += item.shape[0] if batched else item.shape[1]
                        continue
                    # Chain: add the upstream aggregate to our own block in
                    # byte-budgeted slices (one engine chunk never buffers
                    # unbounded upstream bytes; the feed prefetched them
                    # while the chunk computed). A short upstream truncates
                    # the whole chain (shortest-prefix, the coordinator's
                    # alignment rule).
                    pos = 0
                    need = item.shape[0]
                    while pos < need:
                        take = min(budget, need - pos)
                        try:
                            up_block = await feed.take(
                                take, self.upstream_timeout
                            )
                        except (asyncio.TimeoutError,
                                ConnectionResetError,
                                asyncio.IncompleteReadError) as e:
                            # A connected-but-silent upstream (deadline) or a
                            # mid-stream reset (an aborting chain above us)
                            # must not look like a clean shorter scan
                            # downstream — cascade the abort.
                            log.error(
                                "upstream %s failed mid-chain (%s) — "
                                "aborting the chain reply", upstream[-1],
                                e or "stalled",
                            )
                            self.failed += 1
                            writer.transport.abort()
                            return
                        n = up_block.shape[0]
                        if n:
                            # uint16 + uint16 wraps mod 2^16 — the share sum.
                            writer.write(to_bytes(item[pos:pos + n] + up_block))
                            await writer.drain()
                            sent += n
                        pos += n
                        if n < take:  # feed returns short ONLY at EOF
                            log.warning(
                                "upstream %s ended at %d entries — "
                                "truncating the chain reply", upstream[-1],
                                sent,
                            )
                            truncated = True
                            break
                log.info("reply sent: %d entries x %d queries%s",
                         sent, qpat.shape[0],
                         f" (chain of {len(upstream) + 1})" if self.wire == "chain" else "")
                self._count_request(time.monotonic() - t0, sent)
            finally:
                pump.close()
                if feed is not None:
                    feed.close()
                if up_writer is not None:
                    up_writer.close()
                    try:
                        await up_writer.wait_closed()
                    except (ConnectionResetError, BrokenPipeError, OSError):
                        pass
        except asyncio.TimeoutError:
            log.warning(
                "connection from %s sent no complete query within %.1fs — "
                "closing (stalled client, SPEC section 5)",
                peer, self.read_timeout,
            )
        except (asyncio.IncompleteReadError, ConnectionResetError, ValueError) as e:
            log.warning("connection from %s dropped/invalid: %s", peer, e)
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
