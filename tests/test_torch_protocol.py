"""The port's MPC serving roles (``mpc_iris_tpu_torch.protocol``) on the CPU,
part 1: the coordinator's rounds over the reference, batched and chain wires,
strict scans, the wire helpers and the pump.

Each case of ``tests/test_protocol.py`` and ``tests/test_wire.py`` is carried
over with its seed and its assertions, and runs on both stacks
(``torch_protocol_world.both``): the port's roles over the port's engines
give the outcomes of the JAX roles over the JAX engines, exactly (index, f64
distance bit for bit, total).
"""

import asyncio
import threading
import warnings

import numpy as np
import pytest

from mpc_iris_tpu import native
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.types import Template
from mpc_iris_tpu_torch.protocol.coordinator import _rechunk
from mpc_iris_tpu_torch.protocol.pump import put_blocking
from mpc_iris_tpu_torch.protocol.wire import (
    BATCHED_MAGIC,
    batched_query_bytes,
    batched_records_to_bytes,
    read_batched_query,
    read_batched_records,
    read_records,
)

from torch_protocol_world import (
    JAX,
    PORT,
    both,
    build_party_data,
    close_all,
    oracle_matrix,
)


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


def test_oracle_matrix_equals_template_distance(world):
    rng, db, query, masks = world
    queries = [query, db[3], Template.random(np.random.default_rng(5))]
    np.testing.assert_array_equal(oracle_matrix(queries, db),
                                  [oracle_of(q, db) for q in queries])


def run_protocol(world, n_parties, local_share=False, batch_records=7, chunk=8):
    rng, db, query, masks = world
    mats = build_party_data(rng, db, n_parties)

    async def go(s):
        local_engine = None
        remote_mats = mats
        if local_share:
            local_engine = s.share(mats[0], chunk=chunk)
            remote_mats = mats[1:]
        servers = [s.participant(s.share(m, chunk=chunk)) for m in remote_mats]
        addrs = [await p.start() for p in servers]
        coord = s.coordinator(s.masks(masks, chunk=chunk), addrs, local_engine=local_engine,
                              batch_records=batch_records)
        try:
            return await coord.query(s.t(query))
        finally:
            await close_all(*servers)

    return both(go)


class TestProtocol:
    def test_two_party_matches_oracle(self, world):
        rng, db, query, masks = world
        outcome = run_protocol(world, 2)
        oracle = oracle_of(query, db)
        assert outcome.total == len(db)
        assert outcome.index == int(np.argmin(oracle))
        assert outcome.distance == oracle.min()

    def test_three_party(self, world):
        rng, db, query, masks = world
        outcome = run_protocol(world, 3, batch_records=23)
        oracle = oracle_of(query, db)
        assert (outcome.index, outcome.distance) == (int(np.argmin(oracle)), oracle.min())

    def test_coordinator_holds_share(self, world):
        rng, db, query, masks = world
        outcome = run_protocol(world, 3, local_share=True)
        oracle = oracle_of(query, db)
        assert (outcome.index, outcome.distance) == (int(np.argmin(oracle)), oracle.min())

    def test_coordinator_holds_keyed_share(self, world):
        """The coordinator's own share is PRF-backed and regenerated from the
        32-byte key: no share data at all on the coordinator."""
        rng, db, query, masks = world
        enc = np.stack([encode_template(t).data for t in db])
        key = native.derive_insecure_key(31)
        shares = native.share_split(enc, 3, key)

        async def go(s):
            servers = [s.participant(s.share(m)) for m in shares[1:]]
            addrs = [await p.start() for p in servers]
            coord = s.coordinator(s.masks(masks), addrs,
                                  local_engine=s.keyed(key, 0, len(db)), batch_records=7)
            try:
                return await coord.query(s.t(query))
            finally:
                await close_all(*servers)

        outcome = both(go)
        oracle = oracle_of(query, db)
        assert (outcome.index, outcome.distance) == (int(np.argmin(oracle)), oracle.min())

    def test_single_party_is_plaintext(self, world):
        rng, db, query, masks = world
        outcome = run_protocol(world, 1)
        assert outcome.distance == oracle_of(query, db).min()

    def test_shorter_party_truncates(self, world):
        """A party with fewer entries truncates the comparison to the common
        prefix (reference src/main.rs:565-569)."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go(s):
            servers = [s.participant(s.share(mats[0])), s.participant(s.share(mats[1][:11]))]
            addrs = [await p.start() for p in servers]
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            try:
                return await coord.query(s.t(query))
            finally:
                await close_all(*servers)

        outcome = both(go)
        assert outcome.total == 11
        oracle = oracle_of(query, db[:11])
        assert outcome.index == int(np.argmin(oracle))
        assert outcome.distance == oracle.min()


class TestStrictScan:
    def test_aborts_on_midstream_crash(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        half = len(db) // 2

        async def go(s):
            async def crashing_party(reader, writer):
                await reader.readexactly(3200)
                full = s.share(mats[1]).dots(query.pattern.data[None],
                                             query.mask.data[None])[0]
                writer.write(full[:half].astype("<u2").tobytes())
                await writer.drain()
                writer.close()

            real = s.participant(s.share(mats[0]))
            a0 = await real.start()
            fake = await asyncio.start_server(crashing_party, "127.0.0.1", 0)
            a1 = fake.sockets[0].getsockname()[:2]
            coord = s.coordinator(s.masks(masks), [a0, a1], batch_records=7, strict_scan=True)
            try:
                with pytest.raises(s.protocol.TruncatedScanError) as ei:
                    await coord.query(s.t(query))
                return str(ei.value).replace(str(a0[1]), "A0").replace(str(a1[1]), "A1")
            finally:
                await real.close()
                fake.close()
                await fake.wait_closed()

        msg = both(go)
        assert f"{half}/{len(db)}" in msg
        assert f"sent {half}" in msg

    def test_full_scan_passes_strict(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        oracle = oracle_of(query, db)

        async def go(s, wire):
            servers = [s.participant(s.share(m), wire=wire) for m in mats]
            addrs = [await p.start() for p in servers]
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7, strict_scan=True)
            try:
                if wire == "reference":
                    return await coord.query(s.t(query))
                return await coord.query_batch([s.t(query), s.t(db[2])])
            finally:
                await close_all(*servers)

        single = both(go, "reference")
        assert single.total == len(db)
        assert (single.index, single.distance) == (int(np.argmin(oracle)), oracle.min())
        batch = both(go, "batched")
        assert batch[0].total == len(db)
        assert (batch[0].index, batch[0].distance) == (int(np.argmin(oracle)), oracle.min())
        assert batch[1].distance == 0.0 and batch[1].index == 2


class TestRechunk:
    def test_rechunk_sizes(self):
        chunks = [np.ones((1, n, 31), dtype=np.uint16) * i for i, n in enumerate([5, 3, 9, 1])]
        out = list(_rechunk(iter(chunks), 7))
        assert [o.shape[0] for o in out] == [7, 7, 4]
        np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks], axis=0),
                                      np.concatenate(out, axis=0))


class TestBatchedWire:
    def test_batched_matches_oracle_and_single(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        queries = [query, Template.random(np.random.default_rng(5)), db[3]]

        async def go(s):
            servers = [s.participant(s.share(m), wire="batched") for m in mats]
            addrs = [await p.start() for p in servers]
            coord = s.coordinator(s.masks(masks), addrs, batch_records=7)
            try:
                return await coord.query_batch([s.t(q) for q in queries])
            finally:
                await close_all(*servers)

        outcomes = both(go)
        assert len(outcomes) == 3
        for q, outcome in zip(queries, outcomes):
            oracle = oracle_of(q, db)
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_byte_budgeted_records_per_read(self):
        from mpc_iris_tpu_torch.constants import REPLY_RECORD_BYTES
        from mpc_iris_tpu_torch.protocol.wire import (
            BATCH_RECORDS, READ_BYTE_BUDGET, records_per_read,
        )

        assert records_per_read(1) == BATCH_RECORDS
        for b in (256, 4096, 65536):
            r = records_per_read(b)
            assert 1 <= r <= BATCH_RECORDS
            assert r * b * REPLY_RECORD_BYTES <= READ_BYTE_BUDGET
            assert r == JAX.wire.records_per_read(b)
        assert records_per_read(65536) >= 1

    def test_batched_b256_multi_round(self, world, monkeypatch):
        """B=256 with a budget that forces several byte-budgeted read rounds
        (7 entry-groups a round: 4 rounds over the 23-entry DB)."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        qrng = np.random.default_rng(11)
        queries = [query] + [Template.random(qrng) for _ in range(255)]
        queries[100] = db[4]  # plant a mid-batch exact hit
        for s in (PORT, JAX):
            monkeypatch.setattr(s.wire, "READ_BYTE_BUDGET", 7 * 256 * 62, raising=True)

        async def go(s):
            servers = [s.participant(s.share(m), wire="batched") for m in mats]
            addrs = [await p.start() for p in servers]
            coord = s.coordinator(s.masks(masks), addrs)
            try:
                return await coord.query_batch([s.t(q) for q in queries])
            finally:
                await close_all(*servers)

        outcomes = both(go)
        assert len(outcomes) == 256
        # Template.distance for all 256 x 23 pairs, whole-array
        for oracle, outcome in zip(oracle_matrix(queries, db), outcomes):
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_batched_with_local_share(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 3)
        queries = [query, db[2]]

        async def go(s):
            servers = [s.participant(s.share(m), wire="batched") for m in mats[1:]]
            addrs = [await p.start() for p in servers]
            coord = s.coordinator(s.masks(masks), addrs, local_engine=s.share(mats[0]),
                                  batch_records=23)
            try:
                return await coord.query_batch([s.t(q) for q in queries])
            finally:
                await close_all(*servers)

        for q, outcome in zip(queries, both(go)):
            oracle = oracle_of(q, db)
            assert (outcome.index, outcome.distance) == (int(np.argmin(oracle)), oracle.min())

    def test_round_times_one_entry_a_read_round(self, world):
        """The port's per-round timing hook: 7 entry-groups a round over the
        23-entry DB make 4 read rounds a query, each appending its staging
        time (the device times are None on the CPU); timing leaves the
        outcome as it was."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go():
            servers = [PORT.participant(PORT.share(m), wire="batched") for m in mats]
            addrs = [await p.start() for p in servers]
            coord = PORT.coordinator(PORT.masks(masks), addrs, batch_records=7)
            try:
                plain = await coord.query_batch([PORT.t(query)])
                coord.round_times = []
                timed = await coord.query_batch([PORT.t(query)])
                return plain, timed, coord.round_times
            finally:
                await close_all(*servers)

        plain, timed, times = asyncio.run(go())
        assert [(o.index, o.distance, o.total) for o in timed] == [
            (o.index, o.distance, o.total) for o in plain]
        assert len(times) == 4
        assert all(st >= 0.0 and up is None and dec is None for st, up, dec in times)


class TestChain:
    """Chained reply aggregation (SPEC section 5.4): the coordinator contacts
    only the chain head and reconstructs with its own local share."""

    @staticmethod
    async def _run_chain(s, world, mats, templates, trim_root=None, batch_records=7):
        rng, db, query, masks = world
        root_rows = mats[0] if trim_root is None else mats[0][:trim_root]
        parts = [s.participant(s.share(m), wire="chain") for m in (root_rows, mats[1], mats[2])]
        addrs = [await p.start() for p in parts]
        coord = s.coordinator(s.masks(masks), addrs, local_engine=s.share(mats[3]),
                              batch_records=batch_records, chain=True)
        try:
            return await coord.query_batch([s.t(t) for t in templates])
        finally:
            await close_all(*parts)

    def test_chain_matches_standard_and_oracle(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 4)
        q2 = Template.random(np.random.default_rng(77))
        outcomes = both(self._run_chain, world, mats, [query, q2])
        for q, outcome in zip((query, q2), outcomes):
            oracle = oracle_of(q, db)
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()

    def test_chain_solo_query_routes_through_batch(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 4)

        async def go(s):
            parts = [s.participant(s.share(m), wire="chain") for m in mats[:3]]
            addrs = [await p.start() for p in parts]
            coord = s.coordinator(s.masks(masks), addrs, local_engine=s.share(mats[3]),
                                  batch_records=7, chain=True)
            try:
                return await coord.query(s.t(query))
            finally:
                await close_all(*parts)

        outcome = both(go)
        oracle = oracle_of(query, db)
        assert (outcome.index, outcome.distance, outcome.total) == (
            int(np.argmin(oracle)), oracle.min(), len(db))

    def test_chain_requires_local_share(self, world):
        rng, db, query, masks = world
        with pytest.raises(ValueError, match="chain mode requires"):
            PORT.coordinator(PORT.masks(masks), [("127.0.0.1", 1)], chain=True)

    def test_chain_shorter_root_truncates_whole_chain(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 4)
        outcomes = both(self._run_chain, world, mats, [query], 11)
        assert outcomes[0].total == 11
        oracle = oracle_of(query, db[:11])
        assert outcomes[0].index == int(np.argmin(oracle))
        assert outcomes[0].distance == oracle.min()

    def test_chain_unreachable_upstream_fails_loud(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 3)

        async def go(s):
            head = s.participant(s.share(mats[1]), wire="chain")
            addr = await head.start()
            coord = s.coordinator(s.masks(masks), [("127.0.0.1", 9), addr],
                                  local_engine=s.share(mats[2]), batch_records=7, chain=True)
            try:
                with pytest.raises(ConnectionError):
                    await coord.query_batch([s.t(query)])
            finally:
                await head.close()

        both(go)

    def test_chain_composes_with_serving_front(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 4)
        q2 = Template.random(np.random.default_rng(88))

        async def go(s):
            parts = [s.participant(s.share(m), wire="chain") for m in mats[:3]]
            addrs = [await p.start() for p in parts]
            coord = s.coordinator(s.masks(masks), addrs, local_engine=s.share(mats[3]),
                                  batch_records=7, chain=True)
            server = s.query_server(coord, max_batch=2, batch_window=0.2, rounds_inflight=2)
            host, port = await server.start()
            try:
                return await asyncio.gather(s.protocol.query_remote(host, port, s.t(query)),
                                            s.protocol.query_remote(host, port, s.t(q2)))
            finally:
                await server.close()
                await close_all(*parts)

        for q, outcome in zip((query, q2), both(go)):
            oracle = oracle_of(q, db)
            assert outcome.total == len(db)
            assert outcome.index == int(np.argmin(oracle))
            assert outcome.distance == oracle.min()


# ------------------------------------------------------------------ wire helpers


def _run_with(data: bytes, fn):
    async def go():
        r = asyncio.StreamReader()
        r.feed_data(data)
        r.feed_eof()
        return await fn(r)

    return asyncio.run(go())


def test_batched_query_roundtrip(rng):
    pats = rng.integers(0, 256, (5, 1600), dtype=np.uint8)
    msks = rng.integers(0, 256, (5, 1600), dtype=np.uint8)
    raw = batched_query_bytes(pats, msks)
    assert raw.startswith(BATCHED_MAGIC) and raw == JAX.wire.batched_query_bytes(pats, msks)
    p2, m2 = _run_with(raw, read_batched_query)
    np.testing.assert_array_equal(p2, pats)
    np.testing.assert_array_equal(m2, msks)


def test_batched_query_rejects_reference_bytes(rng):
    raw = rng.integers(0, 256, 3200, dtype=np.uint8).tobytes()
    with pytest.raises(ValueError, match="batched-wire"):
        _run_with(raw, read_batched_query)


def test_batched_records_roundtrip_and_partial_group_truncation(rng):
    b, n = 3, 7
    block = rng.integers(0, 1 << 16, (n, b, 31), dtype=np.uint16)
    raw = batched_records_to_bytes(block)
    assert len(raw) == n * b * 62 and raw == JAX.wire.batched_records_to_bytes(block)
    got, eof = _run_with(raw, lambda r: read_batched_records(r, b, max_records=100))
    assert eof
    np.testing.assert_array_equal(got, block)
    cut = raw[: (n - 1) * b * 62 + b * 31]  # mid-group
    got, eof = _run_with(cut, lambda r: read_batched_records(r, b, max_records=100))
    assert eof and got.shape == (n - 1, b, 31)
    np.testing.assert_array_equal(got, block[: n - 1])


def test_read_records_partial_record_truncation(rng):
    recs = rng.integers(0, 1 << 16, (4, 31), dtype=np.uint16)
    raw = recs.astype("<u2").tobytes()
    got, eof = _run_with(raw[:-5], lambda r: read_records(r, max_records=100))
    assert eof and got.shape == (3, 31)
    np.testing.assert_array_equal(got, recs[:3])


def test_rechunk_entry_major(rng):
    chunks = [rng.integers(0, 9, (n, 2, 31), dtype=np.uint16) for n in (5, 3, 9, 1)]
    out = list(_rechunk(iter(chunks), 7, squeeze=False, entry_axis=0))
    assert [o.shape[0] for o in out] == [7, 7, 4]
    np.testing.assert_array_equal(np.concatenate(chunks, axis=0), np.concatenate(out, axis=0))


def test_pump_put_blocking_survives_loop_death():
    """A pump worker blocked on a full queue when the event loop CLOSES exits
    promptly and retires the pending queue.put coroutine."""
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    stop = threading.Event()  # never set: only loop death may release it
    result = {}

    async def fill_then_park():
        q = asyncio.Queue(maxsize=1)
        await q.put("full")
        result["q"] = q
        ready.set()
        await asyncio.sleep(0.6)

    def run_loop():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(fill_then_park())
        finally:
            for task in asyncio.all_tasks(loop):
                task.cancel()
            loop.close()
            asyncio.set_event_loop(None)

    t = threading.Thread(target=run_loop)
    t.start()
    assert ready.wait(10)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        worker_done = threading.Event()

        def worker():
            result["ok"] = put_blocking(result["q"], "blocked", loop, stop)
            worker_done.set()

        w = threading.Thread(target=worker, daemon=True)
        w.start()
        t.join(20)
        assert worker_done.wait(10), "worker spun past loop death"
        w.join(10)
        import gc

        gc.collect()
    assert result["ok"] is False
