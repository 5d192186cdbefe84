"""The port's MPC serving roles on the CPU, part 2: the serving front
(``QueryServer``: one-shot, persistent, micro-batched, pipelined rounds,
failures, drain and close), concurrent coordinators on one participant, and
the audit service (``query_under``, ``query_batch_under``,
``query_remote_under``).

The cases of ``tests/test_protocol.py`` (``TestQueryServer``,
``TestConcurrentConnections``, ``TestDrain``) and of
``tests/test_threshold.py::TestCoordinatorQueryUnder`` keep their seeds and
assertions. Where a case ends in outcomes it runs on both stacks
(``torch_protocol_world.both``) and the port's outcomes must equal the JAX
roles' over the JAX engines; the cases about shutdown, deadlines and worker
threads run on the port alone.
"""

import asyncio
import logging
import threading
import time

import numpy as np
import pytest

from mpc_iris_tpu.types import Template

from torch_protocol_world import PORT, both, build_party_data, close_all, norm


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(99)
    db = [Template.random(rng) for _ in range(23)]
    query = Template.random(rng)
    db[17] = query.rotated(5)  # plant the winner
    masks = np.stack([t.mask.data for t in db])
    return rng, db, query, masks


def oracle_of(q, db):
    return np.array([q.distance(t) for t in db])


async def start_parties(s, mats, **kw):
    parts = [s.participant(s.share(m), **kw) for m in mats]
    return parts, [await p.start() for p in parts]


async def raw_query(host, port, q):
    """A client sending one raw template and reading to EOF."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(q.to_bytes())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), timeout=10)
    writer.close()
    await writer.wait_closed()
    return data


class TestQueryServer:
    def test_serve_round_trip_matches_oracle(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(21))

        async def go(s):
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord)
            host, port = await server.start()
            qr = s.protocol.query_remote
            try:
                seq = [await qr(host, port, s.t(q)) for q in (query, q2)]
                con = await asyncio.gather(qr(host, port, s.t(query)), qr(host, port, s.t(q2)))
                return seq, list(con)
            finally:
                await server.close()
                await close_all(*parts)

        seq, con = both(go)
        for q, outcome in zip((query, q2), seq):
            oracle = oracle_of(q, db)
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()
        for sq, c in zip(seq, con):
            assert (c.index, c.distance, c.total) == (sq.index, sq.distance, sq.total)

    def test_persistent_wire_reuses_one_connection(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(21))
        q3 = db[7]

        async def go(s):
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord)
            host, port = await server.start()
            try:
                client = await s.protocol.PersistentQueryClient.connect(host, port)
                persist = [await client.query(s.t(q)) for q in (query, q2, q3)]
                await client.close()
                solo = [await s.protocol.query_remote(host, port, s.t(q))
                        for q in (query, q2, q3)]
                return persist, solo, server.stats()["served"]
            finally:
                await server.close()
                await close_all(*parts)

        persist, solo, served = both(go)
        for p, sq in zip(persist, solo):
            assert (p.index, p.distance, p.total) == (sq.index, sq.distance, sq.total)
        oracle = oracle_of(query, db)
        assert persist[0].index == int(np.argmin(oracle))
        assert persist[0].distance == oracle.min()
        assert persist[2].distance == 0.0  # q3 is a DB self-match
        assert served == 6

    def test_persistent_wire_composes_with_micro_batching(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(88))

        async def go(s):
            parts, addrs = await start_parties(s, mats, wire="batched")
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, max_batch=2, batch_window=0.25)
            host, port = await server.start()
            try:
                c1 = await s.protocol.PersistentQueryClient.connect(host, port)
                c2 = await s.protocol.PersistentQueryClient.connect(host, port)
                round1 = await asyncio.gather(c1.query(s.t(query)), c2.query(s.t(q2)))
                round2 = await asyncio.gather(c1.query(s.t(q2)), c2.query(s.t(query)))
                await c1.close()
                await c2.close()
                return list(round1), list(round2)
            finally:
                await server.close()
                await close_all(*parts)

        (o1, o2), (o2b, o1b) = both(go)
        for q, outs in ((query, (o1, o1b)), (q2, (o2, o2b))):
            oracle = oracle_of(q, db)
            for out in outs:
                assert out.total == len(db)
                assert out.index == int(np.argmin(oracle))
                assert out.distance == oracle.min()

    def test_idle_persistent_session_does_not_block_drain(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        s = PORT

        async def go():
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord)
            host, port = await server.start()
            client = await s.protocol.PersistentQueryClient.connect(host, port)
            out = await client.query(s.t(query))  # one served record, then idle
            await asyncio.sleep(0.05)  # let the handler park on the next read
            t0 = time.monotonic()
            ok = await server.drain(grace=10.0)
            dt = time.monotonic() - t0
            with pytest.raises((asyncio.IncompleteReadError, ConnectionError)):
                await client.query(s.t(query))
            await client.close()
            await server.close()
            await close_all(*parts)
            return out, ok, dt

        out, ok, dt = asyncio.run(go())
        assert out.index == int(np.argmin(oracle_of(query, db)))
        assert ok is True
        assert dt < 5.0, f"drain burned {dt:.1f}s on an idle session"

    def test_close_with_idle_persistent_session_does_not_hang(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)
        s = PORT

        async def go():
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord)
            host, port = await server.start()
            client = await s.protocol.PersistentQueryClient.connect(host, port)
            await client.query(s.t(query))
            await asyncio.sleep(0.05)  # handler parks on the next record
            await asyncio.wait_for(server.close(), timeout=10)
            await client.close()
            await close_all(*parts)

        asyncio.run(go())  # wait_for raising TimeoutError = the hang

    def test_persistent_audit_torn_mid_record_is_not_clean_eof(self, world, caplog):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        s = PORT

        async def go():
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, audit=True)
            host, port = await server.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(s.coord.PERSIST_MAGIC + query.to_bytes())  # no threshold
                await writer.drain()
                writer.close()
                await writer.wait_closed()
                await asyncio.sleep(0.2)  # let the handler observe the EOF
            finally:
                await server.close()
                await close_all(*parts)

        with caplog.at_level(logging.WARNING, logger="mpc_iris_tpu_torch.coordinator"):
            asyncio.run(go())
        assert any("dropped" in r.getMessage() for r in caplog.records), \
            [r.getMessage() for r in caplog.records]

    def test_serve_read_timeout_single_deadline(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)
        s = PORT

        async def go():
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, read_timeout=0.6)
            host, port = await server.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                t0 = time.monotonic()
                await asyncio.sleep(0.4)
                writer.write(query.to_bytes()[:8])  # head only, then stall
                await writer.drain()
                eof = await reader.read()  # server closes at the deadline
                dt = time.monotonic() - t0
                writer.close()
                await writer.wait_closed()
                return eof, dt
            finally:
                await server.close()
                await close_all(*parts)

        eof, dt = asyncio.run(go())
        assert eof == b""
        assert dt < 1.1, f"two stacked deadlines: closed after {dt:.2f}s"

    def test_serve_micro_batching_aggregates_concurrent_clients(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(33)
        queries = [query, db[9], Template.random(qrng), Template.random(qrng)]
        conn_count = {}

        async def go(s):
            parts = [s.participant(s.share(m), wire="batched") for m in mats]
            orig = parts[0]._handle
            conn_count[s.name] = 0

            async def counting_handle(reader, writer):
                conn_count[s.name] += 1
                await orig(reader, writer)

            parts[0]._handle = counting_handle  # before start() binds it
            addrs = [await p.start() for p in parts]
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, max_batch=4, batch_window=0.25)
            host, port = await server.start()
            qr = s.protocol.query_remote
            try:
                outcomes = await asyncio.gather(*[qr(host, port, s.t(q)) for q in queries])
                single = await qr(host, port, s.t(queries[0]))
                return list(outcomes), single
            finally:
                await server.close()
                await close_all(*parts)

        outcomes, single = both(go)
        for q, outcome in zip(queries, outcomes):
            oracle = oracle_of(q, db)
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()
        assert conn_count["port"] <= 3
        assert (single.index, single.distance) == (outcomes[0].index, outcomes[0].distance)

    def test_serve_pipelined_rounds_overlap_and_stay_exact(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(44)
        queries = [query, db[3], db[9]] + [Template.random(qrng) for _ in range(5)]
        peak = {}

        async def go(s):
            parts, addrs = await start_parties(s, mats, wire="batched")
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            orig = coord.query_batch
            inflight = [0]
            peak[s.name] = 0

            async def tracking(templates):
                inflight[0] += 1
                peak[s.name] = max(peak[s.name], inflight[0])
                try:
                    await asyncio.sleep(0.05)  # hold the round open
                    return await orig(templates)
                finally:
                    inflight[0] -= 1

            coord.query_batch = tracking
            server = s.query_server(coord, max_batch=2, batch_window=0.01, rounds_inflight=2)
            host, port = await server.start()
            try:
                return list(await asyncio.gather(
                    *[s.protocol.query_remote(host, port, s.t(q)) for q in queries]))
            finally:
                await server.close()
                await close_all(*parts)

        outcomes = both(go)
        assert peak["port"] >= 2, "no two rounds ever overlapped"
        for q, outcome in zip(queries, outcomes):
            oracle = oracle_of(q, db)
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_serve_micro_batching_failure_propagates(self, world):
        rng, db, query, masks = world
        s = PORT

        async def go():
            coord = s.coordinator(s.masks(masks), [("127.0.0.1", 1)])  # unreachable party
            server = s.query_server(coord, max_batch=2, batch_window=0.2)
            host, port = await server.start()
            try:
                return await asyncio.gather(raw_query(host, port, query),
                                            raw_query(host, port, db[2]))
            finally:
                await server.close()

        assert asyncio.run(go()) == [b"", b""]

    def test_serve_failure_closes_without_reply(self, world):
        rng, db, query, masks = world
        s = PORT

        async def go():
            coord = s.coordinator(s.masks(masks), [("127.0.0.1", 1)])
            server = s.query_server(coord)
            host, port = await server.start()
            try:
                return await raw_query(host, port, query)
            finally:
                await server.close()

        assert asyncio.run(go()) == b""

    def test_serve_recovers_after_participant_restart(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = oracle_of(query, db)

        async def go(s):
            p0, p1 = s.participant(s.share(mats[0])), s.participant(s.share(mats[1]))
            a0, a1 = await p0.start(), await p1.start()
            coord = s.coordinator(s.masks(masks), [a0, a1], batch_records=7)
            server = s.query_server(coord)
            host, port = await server.start()
            p1b = None
            try:
                before = await s.protocol.query_remote(host, port, s.t(query))
                await p1.close()  # participant 1 crashes
                failed = await raw_query(host, port, query)
                p1b = s.participant(s.share(mats[1]), a1[0], a1[1])  # back, same address
                await p1b.start()
                after = await s.protocol.query_remote(host, port, s.t(query))
                return before, failed, after
            finally:
                await server.close()
                await p0.close()
                if p1b is not None:
                    await p1b.close()

        before, failed, after = both(go)
        assert failed == b""
        for outcome in (before, after):
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_serve_max_inflight_bounds_solo_rounds(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = oracle_of(query, db)
        peak = {}

        async def go(s):
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, max_inflight=2)
            inflight = [0]
            peak[s.name] = 0
            orig = coord.query

            async def counting_query(template):
                inflight[0] += 1
                peak[s.name] = max(peak[s.name], inflight[0])
                try:
                    return await orig(template)
                finally:
                    inflight[0] -= 1

            coord.query = counting_query
            host, port = await server.start()
            try:
                return list(await asyncio.gather(
                    *[s.protocol.query_remote(host, port, s.t(query)) for _ in range(5)]))
            finally:
                await server.close()
                await close_all(*parts)

        outcomes = both(go)
        assert peak["port"] <= 2
        for outcome in outcomes:
            assert outcome.total == len(db)
            assert (outcome.index, outcome.distance) == (int(np.argmin(oracle)), oracle.min())

    def test_serve_stats_counters(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        s = PORT

        async def go():
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            bad_coord = s.coordinator(s.masks(masks), [("127.0.0.1", 1)])
            server = s.query_server(coord)
            host, port = await server.start()
            try:
                for _ in range(3):
                    await s.protocol.query_remote(host, port, s.t(query))
                good_stats = server.stats()
                server.coordinator = bad_coord
                await raw_query(host, port, query)
                return good_stats, server.stats()
            finally:
                await server.close()
                await close_all(*parts)

        good, after = asyncio.run(go())
        assert good["served"] == 3 and good["failed"] == 0
        assert good["window"] == 3 and good["p50_s"] > 0
        assert good["p95_s"] >= good["p50_s"]
        assert after["served"] == 3 and after["failed"] == 1

    def test_serve_read_timeout_cuts_silent_client(self, world):
        rng, db, query, masks = world
        s = PORT

        async def go():
            coord = s.coordinator(s.masks(masks), [("127.0.0.1", 1)])
            server = s.query_server(coord, read_timeout=0.5)
            host, port = await server.start()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                data = await asyncio.wait_for(reader.read(), timeout=10)
                writer.close()
                await writer.wait_closed()
                return data
            finally:
                await server.close()

        assert asyncio.run(go()) == b""


class TestConcurrentConnections:
    """One participant, several simultaneous coordinators: replies stay
    bit-exact against serial ones, the refresh hook runs serialized per
    request, and no pump worker thread leaks."""

    def test_two_coordinators_reference_wire_bit_exact(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)
        q2 = Template.random(np.random.default_rng(7))
        refresh_calls = []
        s = PORT

        def refresh():
            refresh_calls.append(threading.get_ident())
            time.sleep(0.05)

        async def go():
            server = s.participant(s.share(mats[0]), refresh=refresh)
            addr = await server.start()

            def coord():
                return s.coordinator(s.masks(masks), [addr], batch_records=7)

            try:
                serial = [await coord().query(s.t(q)) for q in (query, q2)]
                concurrent = await asyncio.gather(coord().query(s.t(query)),
                                                  coord().query(s.t(q2)))
                return serial, concurrent
            finally:
                await server.close()

        before = threading.active_count()
        serial, concurrent = asyncio.run(go())
        for sq, c in zip(serial, concurrent):
            assert (c.index, c.distance, c.total) == (sq.index, sq.distance, sq.total)
        assert len(refresh_calls) == 4  # once per request, all serialized
        deadline = time.monotonic() + 5
        while threading.active_count() > before and time.monotonic() < deadline:
            time.sleep(0.1)
        assert threading.active_count() <= before  # no stranded pump workers

    def test_two_coordinators_batched_wire_bit_exact(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(13)
        batch_a = [query, Template.random(qrng)]
        batch_b = [db[6], Template.random(qrng)]
        s = PORT

        async def go():
            servers, addrs = await start_parties(s, mats, wire="batched")

            def coord():
                return s.coordinator(s.masks(masks), addrs, batch_records=7)

            try:
                serial = [await coord().query_batch([s.t(q) for q in bt])
                          for bt in (batch_a, batch_b)]
                concurrent = await asyncio.gather(coord().query_batch([s.t(q) for q in batch_a]),
                                                  coord().query_batch([s.t(q) for q in batch_b]))
                return serial, concurrent
            finally:
                await close_all(*servers)

        before = threading.active_count()
        serial, concurrent = asyncio.run(go())
        assert norm(serial) == norm(list(concurrent))
        deadline = time.monotonic() + 5
        while threading.active_count() > before and time.monotonic() < deadline:
            time.sleep(0.1)
        assert threading.active_count() <= before


class TestDrain:
    """Graceful shutdown: drain() stops accepting and finishes in-flight
    replies under a grace deadline."""

    @staticmethod
    def _gated_engine(inner, gate):
        """Engine wrapper whose stream yields its first chunk, then blocks on
        ``gate`` (a threading.Event) before continuing."""

        class Gated:
            count = inner.count

            def stream(self, qp, qm, entry_major=False):
                first = True
                for item in inner.stream(qp, qm, entry_major=entry_major):
                    yield item
                    if first:
                        assert gate.wait(timeout=30)
                        first = False

        return Gated()

    def test_participant_drain_finishes_inflight_reply(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()
        s = PORT

        async def go():
            server = s.participant(self._gated_engine(s.share(mats[0]), gate))
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            first = await reader.readexactly(8 * 62)  # chunk 0 streamed
            drain = asyncio.ensure_future(server.drain(grace=20))
            await asyncio.sleep(0.1)
            assert not drain.done(), "drain must wait for the in-flight reply"
            with pytest.raises(ConnectionError):
                await asyncio.open_connection(host, port)
            gate.set()
            rest = await reader.read()
            assert await drain is True
            writer.close()
            await writer.wait_closed()
            await server.close()
            return first + rest

        assert len(asyncio.run(go())) == len(db) * 62  # the FULL reply survived

    def test_participant_drain_grace_expires(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()
        s = PORT

        async def go():
            server = s.participant(self._gated_engine(s.share(mats[0]), gate))
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            await reader.readexactly(8 * 62)
            ok = await server.drain(grace=0.2)  # handler still gated
            gate.set()
            writer.close()
            await writer.wait_closed()
            await server.close()
            return ok

        assert asyncio.run(go()) is False

    @pytest.mark.parametrize("expires", [False, True])
    def test_participant_drain_pre_3_12_fallback(self, world, monkeypatch, expires):
        """Before Python 3.12.1 drain polls the ConnectionTracker (forced
        here through the version gate)."""
        monkeypatch.setattr(PORT.drain, "_WAIT_CLOSED_TRACKS_CONNECTIONS", False)
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()
        s = PORT

        async def go():
            server = s.participant(self._gated_engine(s.share(mats[0]), gate))
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            first = await reader.readexactly(8 * 62)
            if expires:
                ok = await server.drain(grace=0.2)
                gate.set()
                rest = await reader.read()
            else:
                drain = asyncio.ensure_future(server.drain(grace=20))
                await asyncio.sleep(0.1)
                assert not drain.done(), "fallback drain must wait on the tracker"
                gate.set()
                rest = await reader.read()
                ok = await drain
            writer.close()
            await writer.wait_closed()
            await server.close()
            return ok, first + rest

        ok, payload = asyncio.run(go())
        assert ok is (not expires)
        assert len(payload) == len(db) * 62

    def test_queryserver_drain_answers_queued_clients(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = Template.random(np.random.default_rng(55))

        async def go(s):
            parts, addrs = await start_parties(s, mats, wire="batched")
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, max_batch=2, batch_window=0.2)
            host, port = await server.start()
            clients = [asyncio.ensure_future(s.protocol.query_remote(host, port, s.t(q)))
                       for q in (query, q2)]
            await asyncio.sleep(0.05)  # let both enqueue into the window
            drained = await server.drain(grace=30)
            outcomes = await asyncio.gather(*clients)
            with pytest.raises(ConnectionError):
                await s.protocol.query_remote(host, port, s.t(query))
            await server.close()
            await close_all(*parts)
            return drained, list(outcomes)

        drained, outcomes = both(go)
        assert drained is True
        for q, outcome in zip((query, q2), outcomes):
            oracle = oracle_of(q, db)
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_close_cancels_parked_dispatcher_batch(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        s = PORT

        async def go():
            release = asyncio.Event()
            parts, addrs = await start_parties(s, mats, wire="batched")
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            orig = coord.query_batch

            async def slow(templates):
                await release.wait()  # round 1 blocks the single gate slot
                return await orig(templates)

            coord.query_batch = slow
            server = s.query_server(coord, max_batch=1, batch_window=0.01, rounds_inflight=1)
            host, port = await server.start()

            async def client(q):
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(q.to_bytes())
                await writer.drain()
                data = await asyncio.wait_for(reader.read(), timeout=15)
                writer.close()
                await writer.wait_closed()
                return data

            c1 = asyncio.ensure_future(client(query))
            c2 = asyncio.ensure_future(client(db[2]))
            await asyncio.sleep(0.3)  # round 1 in flight, batch 2 parked
            await asyncio.wait_for(server.close(), timeout=10)
            release.set()
            replies = await asyncio.gather(c1, c2)
            await close_all(*parts)
            return replies

        assert asyncio.run(go()) == [b"", b""]

    def test_abort_connections_after_failed_drain(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        gate = threading.Event()
        s = PORT

        async def go():
            server = s.participant(self._gated_engine(s.share(mats[0]), gate))
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            await reader.readexactly(8 * 62)
            assert await server.drain(grace=0.2) is False
            assert server.abort_connections() == 1
            gate.set()  # un-wedge the engine thread so the pump can exit
            await asyncio.wait_for(server.close(), timeout=10)
            try:
                rest = await asyncio.wait_for(reader.read(), timeout=5)
            except ConnectionResetError:
                rest = b""
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionResetError:
                pass
            return rest

        assert len(asyncio.run(go())) < (len(db) - 8) * 62  # reply cut short


# ------------------------------------------------------------------ the audit service


class TestCoordinatorQueryUnder:
    @pytest.fixture(scope="class")
    def world(self):
        rng = np.random.default_rng(99)
        db = [Template.random(rng) for _ in range(23)]
        query = Template.random(rng)
        db[17] = query.rotated(5)  # exact duplicate
        db[3] = query.rotated(-2)  # second exact duplicate
        masks = np.stack([t.mask.data for t in db])
        return rng, db, query, masks

    def run_under(self, world, threshold, n_parties=2, local_share=False):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, n_parties)

        async def go(s):
            local_engine = None
            remote = mats
            if local_share:
                local_engine = s.share(mats[0])
                remote = mats[1:]
            servers, addrs = await start_parties(s, remote)
            coord = s.coordinator(s.masks(masks), addrs, local_engine=local_engine,
                                  batch_records=7)
            try:
                return await coord.query_under(s.t(query), threshold)
            finally:
                await close_all(*servers)

        return both(go)

    def test_matches_oracle(self, world):
        rng, db, query, masks = world
        oracle = oracle_of(query, db)
        t = float(np.median(oracle))
        out = self.run_under(world, t)
        assert out.total == len(db)
        assert sorted(m.index for m in out.matches) == sorted(np.nonzero(oracle < t)[0].tolist())
        for m in out.matches:
            assert m.distance == oracle[m.index]
        ds = [m.distance for m in out.matches]
        assert ds == sorted(ds)

    def test_duplicates_listed_with_local_share(self, world):
        out = self.run_under(world, 1e-9, n_parties=3, local_share=True)
        assert [m.index for m in out.matches] == [3, 17]
        assert all(m.distance == 0.0 for m in out.matches)

    def test_strict_threshold_zero(self, world):
        out = self.run_under(world, 0.0)
        assert out.matches == []
        assert out.total == 23

    def test_audit_serving_wire_round_trip(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = oracle_of(query, db)
        t = float(np.median(oracle))

        async def go(s):
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, audit=True)
            host, port = await server.start()
            try:
                hit = await s.protocol.query_remote_under(host, port, s.t(query), t)
                none = await s.protocol.query_remote_under(host, port, s.t(query), 0.0)
                return hit, none
            finally:
                await server.close()
                await close_all(*parts)

        hit, none = both(go)
        assert hit.total == len(db)
        assert sorted(m.index for m in hit.matches) == sorted(np.nonzero(oracle < t)[0].tolist())
        for m in hit.matches:
            assert m.distance == oracle[m.index]
        assert none.matches == [] and none.total == len(db)

    def test_audit_serving_micro_batched_mixed_thresholds(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = db[5]
        oracle_q, oracle_2 = oracle_of(query, db), oracle_of(q2, db)
        t1 = float(np.median(oracle_q))
        t2 = float(np.quantile(oracle_2, 0.25))

        async def go(s):
            parts, addrs = await start_parties(s, mats, wire="batched")
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, audit=True, max_batch=2, batch_window=0.25)
            host, port = await server.start()
            qru = s.protocol.query_remote_under
            try:
                return list(await asyncio.gather(qru(host, port, s.t(query), t1),
                                                 qru(host, port, s.t(q2), t2)))
            finally:
                await server.close()
                await close_all(*parts)

        o1, o2 = both(go)
        for out, oracle, t in ((o1, oracle_q, t1), (o2, oracle_2, t2)):
            assert out.total == len(db)
            assert sorted(m.index for m in out.matches) == \
                sorted(np.nonzero(oracle < t)[0].tolist())
            for m in out.matches:
                assert m.distance == oracle[m.index]

    def test_audit_serving_limit_guard(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = oracle_of(query, db)
        t_small = 1e-9  # exact duplicates only (2 planted)

        async def go(s):
            parts, addrs = await start_parties(s, mats, wire="batched")
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, audit=True, max_batch=2, batch_window=0.25,
                                    max_matches=3)
            host, port = await server.start()
            qru = s.protocol.query_remote_under
            try:
                greedy, modest = await asyncio.gather(
                    qru(host, port, s.t(query), 1.0),  # all entries
                    qru(host, port, s.t(query), t_small),
                    return_exceptions=True)
                return type(greedy).__name__, modest, server.stats()["failed"], \
                    server.stats()["served"]
            finally:
                await server.close()
                await close_all(*parts)

        greedy, modest, failed, served = both(go)
        assert greedy == "IncompleteReadError"
        assert sorted(m.index for m in modest.matches) == \
            sorted(np.nonzero(oracle < t_small)[0].tolist())
        assert failed == 1 and served == 1

    def test_audit_serving_failure_closes_short(self, world):
        rng, db, query, masks = world
        s = PORT

        async def go():
            coord = s.coordinator(s.masks(masks), [("127.0.0.1", 1)])
            server = s.query_server(coord, audit=True)
            host, port = await server.start()
            try:
                with pytest.raises(asyncio.IncompleteReadError):
                    await asyncio.wait_for(
                        s.protocol.query_remote_under(host, port, s.t(query), 0.5), timeout=10)
            finally:
                await server.close()

        asyncio.run(go())

    def test_audit_serving_rejects_nonfinite_threshold(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go(s):
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, audit=True)
            host, port = await server.start()
            qru = s.protocol.query_remote_under
            try:
                bad = await asyncio.gather(qru(host, port, s.t(query), float("nan")),
                                           qru(host, port, s.t(query), float("inf")),
                                           return_exceptions=True)
                ok = await qru(host, port, s.t(query), 1e-9)
                return [type(b).__name__ for b in bad], ok, server.stats()["failed"], \
                    server.stats()["served"]
            finally:
                await server.close()
                await close_all(*parts)

        bad, ok, failed, served = both(go)
        assert bad == ["IncompleteReadError"] * 2
        assert sorted(m.index for m in ok.matches) == [3, 17]
        assert failed == 2 and served == 1

    def test_audit_client_bounds_server_count(self, world):
        rng, db, query, masks = world
        s = PORT

        async def evil(reader, writer):
            await reader.readexactly(3200 + s.coord.AUDIT_THRESHOLD.size)
            writer.write(s.coord.AUDIT_HEAD.pack(2**60, 23))  # exabytes of "matches"
            await writer.drain()
            writer.close()

        async def go():
            server = await asyncio.start_server(evil, "127.0.0.1", 0)
            host, port = server.sockets[0].getsockname()[:2]
            try:
                with pytest.raises(ConnectionError, match="client cap"):
                    await s.protocol.query_remote_under(host, port, s.t(query), 0.5)
            finally:
                server.close()
                await server.wait_closed()

        asyncio.run(go())

    def test_persistent_audit_wire(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = oracle_of(query, db)
        t1 = float(np.median(oracle))
        t2 = 1e-9

        async def go(s):
            parts, addrs = await start_parties(s, mats)
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            server = s.query_server(coord, audit=True, max_matches=len(db) // 2)
            host, port = await server.start()
            try:
                c = await s.protocol.PersistentQueryClient.connect(host, port, audit=True)
                a1 = await c.query_under(s.t(query), t1)
                a2 = await c.query_under(s.t(query), t2)
                with pytest.raises(asyncio.IncompleteReadError):
                    await c.query_under(s.t(query), 1.0)  # over max_matches
                await c.close()
                solo1 = await s.protocol.query_remote_under(host, port, s.t(query), t1)
                return a1, a2, solo1, server.stats()["served"], server.stats()["failed"]
            finally:
                await server.close()
                await close_all(*parts)

        a1, a2, solo1, served, failed = both(go)
        assert [(m.index, m.distance) for m in a1.matches] == \
            [(m.index, m.distance) for m in solo1.matches]
        assert sorted(m.index for m in a2.matches) == [3, 17]
        assert served == 3 and failed == 1

    def test_batched_audit_matches_single(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        q2 = db[5]
        t = float(np.median(oracle_of(query, db)))

        async def go(s):
            servers, addrs = await start_parties(s, mats, wire="batched")
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            try:
                return await coord.query_batch_under([s.t(query), s.t(q2)], t)
            finally:
                await close_all(*servers)

        outs = both(go)
        assert len(outs) == 2
        for q, out in zip((query, q2), outs):
            oracle = oracle_of(q, db)
            assert out.total == len(db)
            assert sorted(m.index for m in out.matches) == \
                sorted(np.nonzero(oracle < t)[0].tolist())
            for m in out.matches:
                assert m.distance == oracle[m.index]
        single0 = self.run_under(world, t)
        assert [(m.index, m.distance) for m in outs[0].matches] == \
            [(m.index, m.distance) for m in single0.matches]
