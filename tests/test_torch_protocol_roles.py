"""The port's MPC serving roles on the CPU, part 3: robustness (unreachable,
stalled and silent parties, wire-mode mismatch, dropped clients, serving
counters), TLS on every link, X25519 key agreement, and serving across the
two packages (each package's Coordinator over the other's
ParticipantServers, on the reference, batched and chain wires; the port's
roles over the port's sharded engines).

The cases of ``tests/test_protocol.py::TestRobustness``, ``tests/test_tls.py``
and ``tests/test_keyagree.py`` keep their seeds and assertions; those that
drive the command line (not yet in the port) stay with the JAX package.
Where a case ends in an outcome or an error it runs on both stacks: equal
outcomes, and the same error class from each package.
"""

import asyncio
import hashlib
import hmac
import os
import pathlib
import ssl
import threading
import time

import numpy as np
import pytest

from mpc_iris_tpu import native
from mpc_iris_tpu.ops.encode import encode_template
from mpc_iris_tpu.protocol import keyagree as jkeyagree
from mpc_iris_tpu.types import Template
from mpc_iris_tpu_torch.protocol import keyagree, tlsutil

from torch_protocol_world import CPU, JAX, PORT, both, build_party_data, close_all, norm


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


class TestRobustness:
    def test_masks_only_coordinator_rejected(self, world):
        rng, db, query, masks = world
        for s in (PORT, JAX):
            with pytest.raises(ValueError):
                s.coordinator(s.masks(masks), participants=[])

    def test_oversized_batch_rejected(self, world):
        rng, db, query, masks = world
        for s in (PORT, JAX):
            coord = s.protocol.Coordinator.__new__(s.protocol.Coordinator)  # skip __init__
            coord.participants = []
            coord.masks_engine = None
            coord.local_engine = None
            coord.batch_records = 7
            with pytest.raises(ValueError):
                asyncio.run(coord.query_batch([s.t(query)] * 0))

    def test_client_disconnect_releases_worker(self, world):
        """Dropping the connection mid-stream must not strand the producer
        thread."""
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)
        s = PORT

        async def go():
            server = s.participant(s.share(mats[0], chunk=4))
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())
            await writer.drain()
            await reader.read(62)  # first bytes arrive, then hang up
            writer.close()
            await writer.wait_closed()
            await asyncio.sleep(1.0)  # let the pump notice and exit
            await server.close()

        before = threading.active_count()
        asyncio.run(go())
        deadline = time.monotonic() + 5
        while threading.active_count() > before and time.monotonic() < deadline:
            time.sleep(0.1)
        assert threading.active_count() <= before

    def test_unreachable_participant_clear_error(self, world):
        rng, db, query, masks = world
        for s in (PORT, JAX):
            coord = s.coordinator(s.masks(masks), [("127.0.0.1", 1)])
            with pytest.raises(ConnectionError, match="cannot reach"):
                asyncio.run(coord.query(s.t(query)))

    def test_stalled_party_aborts_within_deadline(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def stalling_handler(reader, writer):
            await reader.readexactly(3200)
            writer.write(b"\x00" * (3 * 62))  # a few whole records, then silence
            await writer.drain()
            await reader.read(1)
            writer.close()

        async def go(s):
            healthy = s.participant(s.share(mats[0]))
            addr0 = await healthy.start()
            stall_srv = await asyncio.start_server(stalling_handler, "127.0.0.1", 0)
            addr1 = stall_srv.sockets[0].getsockname()[:2]
            coord = s.coordinator(s.masks(masks), [addr0, addr1], batch_records=7,
                                  round_timeout=1.0)
            try:
                t0 = time.monotonic()
                with pytest.raises(s.protocol.StalledPartyError, match=f"{addr1[1]}"):
                    await coord.query(s.t(query))
                return time.monotonic() - t0 < 10  # bounded by the deadline
            finally:
                await healthy.close()
                stall_srv.close()
                await stall_srv.wait_closed()

        assert both(go) is True

    def test_stalled_party_aborts_batched_wire(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)

        async def go(s):
            async def stalling_handler(reader, writer):
                await reader.readexactly(len(s.wire.BATCHED_MAGIC) + 4 + 2 * 3200)
                await reader.read(1)  # stall until the coordinator hangs up
                writer.close()

            healthy = s.participant(s.share(mats[0]), wire="batched")
            addr0 = await healthy.start()
            stall_srv = await asyncio.start_server(stalling_handler, "127.0.0.1", 0)
            addr1 = stall_srv.sockets[0].getsockname()[:2]
            coord = s.coordinator(s.masks(masks), [addr0, addr1], batch_records=7,
                                  round_timeout=1.0)
            try:
                with pytest.raises(s.protocol.StalledPartyError, match="no complete"):
                    await coord.query_batch([s.t(query), s.t(db[2])])
            finally:
                await healthy.close()
                stall_srv.close()
                await stall_srv.wait_closed()

        both(go)

    def test_no_timeout_still_waits(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go(s):
            server = s.participant(s.share(mats[0]))
            addr = await server.start()
            coord = s.coordinator(s.masks(masks), [addr], batch_records=7)
            assert coord.round_timeout is None
            try:
                return await coord.query(s.t(query))
            finally:
                await server.close()

        assert both(go).distance == oracle_of(query, db).min()

    def test_participant_read_timeout_closes_silent_client(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)

        async def go(s):
            server = s.participant(s.share(mats[0]), read_timeout=0.5)
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)  # silent client
            data = await asyncio.wait_for(reader.read(), timeout=10)
            assert data == b""  # closed without records
            writer.close()
            await writer.wait_closed()
            coord = s.coordinator(s.masks(masks), [(host, port)], batch_records=7)
            try:
                return await coord.query(s.t(query))
            finally:
                await server.close()

        assert both(go).distance == oracle_of(query, db).min()

    def test_wire_mode_mismatch_fails_fast(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 1)
        s = PORT

        async def go():
            server = s.participant(s.share(mats[0]), wire="batched")
            host, port = await server.start()
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(query.to_bytes())  # reference-wire bytes
            await writer.drain()
            data = await reader.read(62)
            writer.close()
            await writer.wait_closed()
            await server.close()
            return data

        assert asyncio.run(go()) == b""

    def test_participant_stats_counters(self, world):
        rng, db, query, masks = world
        mats = build_party_data(rng, db, 2)
        s = PORT

        async def go():
            server = s.participant(s.share(mats[0]))
            host, port = await server.start()

            async def one():
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(query.to_bytes())
                await writer.drain()
                data = await reader.read()
                writer.close()
                await writer.wait_closed()
                return data

            await one()
            await one()
            stats = server.stats()
            await server.close()
            return stats

        stats = asyncio.run(go())
        assert stats["served"] == 2
        assert stats["failed"] == 0
        assert stats["entries_sent"] == 2 * len(db)
        assert stats["window"] == 2 and stats["p50_s"] > 0


# ------------------------------------------------------------------ TLS

needs_crypto = pytest.mark.skipif(not keyagree.have_crypto(),
                                  reason="cryptography package not installed")


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    out = {}
    for name in ("p0", "p1", "coord", "rogue"):
        out[name] = tlsutil.generate_self_signed(str(d / name), name)
    bundle = d / "parties.pem"
    bundle.write_bytes(pathlib.Path(out["p0"][1]).read_bytes()
                       + pathlib.Path(out["p1"][1]).read_bytes())
    out["bundle"] = str(bundle)
    return out


@pytest.fixture(scope="module")
def tls_world():
    rng = np.random.default_rng(7)
    db = [Template.random(rng) for _ in range(13)]
    query = Template.random(rng)
    db[4] = query.rotated(-3)  # plant the winner
    masks = np.stack([t.mask.data for t in db])
    mats = build_party_data(rng, db, 2)
    return db, query, masks, mats


def _run_tls(tls_world, server_ssl, client_ssl):
    db, query, masks, mats = tls_world

    async def go(s):
        servers = [s.participant(s.share(m), ssl_context=ctx) for m, ctx in zip(mats, server_ssl)]
        addrs = [await p.start() for p in servers]
        coord = s.coordinator(s.masks(masks), addrs, batch_records=5, ssl_context=client_ssl)
        try:
            return await coord.query(s.t(query))
        finally:
            await close_all(*servers)

    return both(go)


@needs_crypto
class TestTLS:
    def test_query_through_tls_tunnel(self, tls_world, certs):
        db, query, masks, mats = tls_world
        server_ssl = [tlsutil.server_context(certs[p][1], certs[p][0]) for p in ("p0", "p1")]
        outcome = _run_tls(tls_world, server_ssl, tlsutil.client_context(certs["bundle"]))
        oracle = oracle_of(query, db)
        assert (outcome.index, outcome.distance) == (int(np.argmin(oracle)), oracle.min())

    def test_mutual_tls_client_auth(self, tls_world, certs):
        db, query, masks, mats = tls_world
        server_ssl = [tlsutil.server_context(certs[p][1], certs[p][0], ca=certs["coord"][1])
                      for p in ("p0", "p1")]
        good = tlsutil.client_context(certs["bundle"], certfile=certs["coord"][1],
                                      keyfile=certs["coord"][0])
        assert _run_tls(tls_world, server_ssl, good).distance == oracle_of(query, db).min()
        anon = tlsutil.client_context(certs["bundle"])  # no client certificate
        with pytest.raises((ConnectionError, ssl.SSLError, asyncio.IncompleteReadError)):
            _run_tls(tls_world, server_ssl, anon)

    def test_untrusted_server_rejected(self, tls_world, certs):
        server_ssl = [tlsutil.server_context(certs["rogue"][1], certs["rogue"][0]),
                      tlsutil.server_context(certs["p1"][1], certs["p1"][0])]
        with pytest.raises(ConnectionError):
            _run_tls(tls_world, server_ssl, tlsutil.client_context(certs["bundle"]))

    def test_tls_cert_mints_usable_pair(self, tmp_path):
        """The port's ``generate_self_signed`` output loads into both server and
        client contexts, refuses to overwrite, and keeps the key private."""
        key, crt = tlsutil.generate_self_signed(str(tmp_path / "p0"), "party0")
        with pytest.raises(FileExistsError):
            tlsutil.generate_self_signed(str(tmp_path / "p0"), "party0")
        assert os.stat(key).st_mode & 0o777 == 0o600
        tlsutil.server_context(crt, key)
        tlsutil.client_context(crt)
        with pytest.raises(ValueError, match="both"):
            tlsutil.client_context(crt, certfile=crt)

    def test_plaintext_client_to_tls_server_fails(self, tls_world, certs):
        server_ssl = [tlsutil.server_context(certs[p][1], certs[p][0]) for p in ("p0", "p1")]
        with pytest.raises((ConnectionError, asyncio.IncompleteReadError, ValueError)):
            _run_tls(tls_world, server_ssl, None)

    def test_query_server_client_facing_tls(self, tls_world, certs):
        db, query, masks, mats = tls_world
        oracle = oracle_of(query, db)
        key, crt = certs["coord"]
        server_ssl = tlsutil.server_context(crt, key)
        good = tlsutil.client_context(crt)
        bad = tlsutil.client_context(certs["rogue"][1])

        async def go(s):
            parts = [s.participant(s.share(m)) for m in mats]
            addrs = [await p.start() for p in parts]
            coord = s.coordinator(s.masks(masks), addrs, batch_records=5)
            server = s.protocol.QueryServer(coord, "127.0.0.1", 0, ssl_context=server_ssl)
            host, port = await server.start()
            try:
                outcome = await s.protocol.query_remote(host, port, s.t(query), ssl_context=good)
                with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
                    await s.protocol.query_remote(host, port, s.t(query), ssl_context=bad)
                return outcome
            finally:
                await server.close()
                await close_all(*parts)

        outcome = both(go)
        assert outcome.total == len(db)
        assert outcome.index == int(np.argmin(oracle))
        assert outcome.distance == oracle.min()

    def test_chain_hops_over_mutual_tls(self, tls_world, certs):
        db, query, masks, _mats = tls_world
        mats = build_party_data(np.random.default_rng(11), db, 3)

        async def go(s):
            root = s.participant(s.share(mats[0]), wire="chain",
                                 ssl_context=tlsutil.server_context(
                                     certs["p0"][1], certs["p0"][0], ca=certs["p1"][1]))
            root_addr = await root.start()
            head = s.participant(s.share(mats[1]), wire="chain",
                                 ssl_context=tlsutil.server_context(certs["p1"][1],
                                                                    certs["p1"][0]),
                                 upstream_ssl_context=tlsutil.client_context(
                                     certs["p0"][1], certfile=certs["p1"][1],
                                     keyfile=certs["p1"][0]))
            head_addr = await head.start()
            coord = s.coordinator(s.masks(masks), [root_addr, head_addr],
                                  local_engine=s.share(mats[2]), batch_records=5,
                                  ssl_context=tlsutil.client_context(certs["p1"][1]),
                                  chain=True)
            try:
                return await coord.query(s.t(query))
            finally:
                await head.close()
                await root.close()

        outcome = both(go)
        oracle = oracle_of(query, db)
        assert (outcome.index, outcome.distance, outcome.total) == (
            int(np.argmin(oracle)), oracle.min(), len(db))

    def test_chain_disallowed_upstream_aborts(self, tls_world, certs):
        db, query, masks, mats = tls_world

        async def go(s):
            head = s.participant(s.share(mats[0]), wire="chain",
                                 allowed_upstreams={"10.0.0.1:1234"})
            head_addr = await head.start()
            coord = s.coordinator(s.masks(masks), [("127.0.0.1", 9), head_addr],
                                  local_engine=s.share(mats[1]), batch_records=5, chain=True)
            try:
                with pytest.raises(ConnectionError):
                    await coord.query_batch([s.t(query)])
            finally:
                await head.close()

        both(go)


# ------------------------------------------------------------------ key agreement

# RFC 7748 section 6.1 test vector.
ALICE_PRIV = "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
ALICE_PUB = "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
BOB_PRIV = "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"
BOB_PUB = "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _write_identity(path, priv_hex):
    with open(path, "w") as f:
        f.write(priv_hex + "\n")


def _hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int = 32) -> bytes:
    """Independent RFC 5869 HKDF (hashlib/hmac only)."""
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    okm, t = b"", b""
    i = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


@needs_crypto
class TestKeyAgree:
    def test_rfc7748_vector_and_independent_hkdf(self, workdir):
        _write_identity("alice.id", ALICE_PRIV)
        assert keyagree.load_identity_public("alice.id").hex() == ALICE_PUB
        got = keyagree.derive_pair_key("alice.id", bytes.fromhex(BOB_PUB), context=b"round-7")
        a, b = sorted((bytes.fromhex(ALICE_PUB), bytes.fromhex(BOB_PUB)))
        assert got == _hkdf_sha256(bytes.fromhex(SHARED), salt=a + b,
                                   info=b"mpc-iris-tpu/pair-key/v1/round-7")
        assert got == jkeyagree.derive_pair_key("alice.id", bytes.fromhex(BOB_PUB),
                                                   context=b"round-7")

    def test_symmetry_and_domain_separation(self, workdir):
        _write_identity("alice.id", ALICE_PRIV)
        _write_identity("bob.id", BOB_PRIV)
        k_ab = keyagree.derive_pair_key("alice.id", bytes.fromhex(BOB_PUB))
        k_ba = keyagree.derive_pair_key("bob.id", bytes.fromhex(ALICE_PUB))
        assert k_ab == k_ba
        assert keyagree.derive_pair_key("alice.id", bytes.fromhex(BOB_PUB),
                                        context=b"epoch2") != k_ab
        pub_c = keyagree.generate_identity("carol.id")
        assert keyagree.derive_pair_key("alice.id", pub_c) != k_ab
        with pytest.raises(ValueError, match="own public key"):
            keyagree.derive_pair_key("alice.id", bytes.fromhex(ALICE_PUB))

    def test_generate_identity_modes_and_refuses_overwrite(self, workdir):
        pub = keyagree.generate_identity("me.id")
        assert (workdir / "me.id").exists()
        assert os.stat(workdir / "me.id").st_mode & 0o777 == 0o600
        assert keyagree.parse_public(str(workdir / "me.id.pub")) == pub
        assert keyagree.load_identity_public("me.id") == pub
        with pytest.raises(FileExistsError):
            keyagree.generate_identity("me.id")


def test_read_key32_accepts_both_printed_forms(tmp_path):
    key = bytes(range(1, 33))
    f_bytes = tmp_path / "bytes.hex"
    f_bytes.write_text(key.hex() + "\n")
    f_int = tmp_path / "printed.hex"
    f_int.write_text(f"0x{int.from_bytes(key, 'little'):064x}\n")
    assert keyagree.read_key32(str(f_bytes)) == key
    assert keyagree.read_key32(str(f_int)) == key
    f_big = tmp_path / "big.hex"
    f_big.write_text(f"0x{1 << 256:x}\n")
    with pytest.raises(ValueError):
        keyagree.read_key32(str(f_big))


# ------------------------------------------------------------------ across the packages


@pytest.fixture(scope="module")
def cross_world():
    """Two keyed parties and the data share of a 3-way split (seed 23, 17
    entries, a rotated copy of the query at 11): the parties and the masks
    engine of each package, from the same key and share."""
    rng = np.random.default_rng(23)
    db = [Template.random(rng) for _ in range(17)]
    query = Template.random(rng)
    db[11] = query.rotated(-4)
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(7)
    shares = native.share_split(enc, 3, key)
    masks = np.stack([t.mask.data for t in db])
    return db, query, key, shares, masks


@pytest.mark.parametrize("wire", ["reference", "batched", "chain"])
@pytest.mark.parametrize("roles,engines", [(PORT, JAX), (JAX, PORT)], ids=["port-coord", "jax-coord"])
def test_cross_serving(cross_world, roles, engines, wire):
    """Each package's Coordinator serves the other's ParticipantServers over
    TCP, each side over its own package's engines: winners and audit lists
    equal the all-port and all-JAX runs and the oracle. Chain: the
    coordinator holds the data share, the keyed parties chain."""
    db, query, key, shares, masks = cross_world
    q2 = db[2]

    async def go(coord_stack, party_stack):
        engines_ = [party_stack.keyed(key, 0, 17), party_stack.keyed(key, 1, 17)]
        local = None
        if wire == "chain":
            local = coord_stack.share(shares[2])
        else:
            engines_.append(party_stack.share(shares[2]))
        parts = [party_stack.participant(e, wire=wire) for e in engines_]
        addrs = [await p.start() for p in parts]
        coord = coord_stack.coordinator(coord_stack.masks(masks), addrs, local_engine=local,
                                        strict_scan=True, chain=wire == "chain")
        t = coord_stack.t
        try:
            if wire == "reference":
                return [await coord.query(t(query)), await coord.query_under(t(query), 0.42)]
            return (await coord.query_batch([t(query), t(q2)])
                    + await coord.query_batch_under([t(query), t(q2)], [0.42, 0.3]))
        finally:
            await close_all(*parts)

    got = asyncio.run(go(roles, engines))
    assert norm(got) == norm(asyncio.run(go(PORT, PORT))) == norm(asyncio.run(go(JAX, JAX)))
    oracle = oracle_of(query, db)
    assert (got[0].index, got[0].distance, got[0].total) == (11, oracle.min(), 17)
    under = got[2] if wire != "reference" else got[1]
    assert [m.index for m in under.matches] == \
        sorted(np.nonzero(oracle < 0.42)[0].tolist(), key=lambda i: (oracle[i], i))
    if wire != "reference":
        assert (got[1].index, got[1].distance) == (2, 0.0)


def test_port_roles_serve_sharded_port_engines():
    """The port's ParticipantServer serves the port's sharded parties (two
    keyed, one data share, on a mesh of 4 CPU shards) over TCP and the
    port's Coordinator runs over the port's ShardedMasksEngine: the winners
    equal the oracle and the JAX roles' over the same engines, on the
    reference wire and the batched one (the counterpart of
    tests/test_torch_parallel.py::test_jax_roles_serve_sharded_port_engines)."""
    from mpc_iris_tpu_torch.parallel import (
        ShardedKeyedShareEngine,
        ShardedMasksEngine,
        ShardedShareEngine,
        make_mesh,
    )

    rng = np.random.default_rng(23)
    db = [Template.random(rng) for _ in range(29)]
    query = Template.random(rng)
    db[21] = query.rotated(-4)
    enc = np.stack([encode_template(t).data for t in db])
    key = native.derive_insecure_key(7)
    shares = native.share_split(enc, 3, key)
    masks = np.stack([t.mask.data for t in db])
    mesh = make_mesh(4, devices=[CPU] * 4)
    parties = [ShardedKeyedShareEngine(key, 0, 29, mesh, chunk=2),
               ShardedKeyedShareEngine(key, 1, 29, mesh, chunk=4),
               ShardedShareEngine(shares[2], mesh, chunk=2)]
    masks_engine = ShardedMasksEngine(masks, mesh, chunk=2)

    async def serve(s, wire, ask):
        servers = [s.participant(e, wire=wire) for e in parties]
        addrs = [await p.start() for p in servers]
        kw = {"device": CPU} if s is PORT else {}
        try:
            return await ask(s, s.protocol.Coordinator(masks_engine, addrs, strict_scan=True,
                                                       **kw))
        finally:
            await close_all(*servers)

    async def go(s):
        return (await serve(s, "reference", lambda s, c: c.query(s.t(query))),
                await serve(s, "batched", lambda s, c: c.query_batch([s.t(query), s.t(db[2])])),
                await serve(s, "batched",
                            lambda s, c: c.query_batch_under([s.t(query)], 0.45)))

    one, batch, (under,) = both(go)
    oracle = oracle_of(query, db)
    assert (one.index, one.distance, one.total) == (21, oracle.min(), 29)
    assert [(o.index, o.distance) for o in batch] == [(21, oracle.min()), (2, 0.0)]
    assert [m.index for m in under.matches] == \
        sorted(np.nonzero(oracle < 0.45)[0].tolist(), key=lambda i: (oracle[i], i))


def test_coordinator_needs_explicit_device(world):
    """The port's Coordinator uploads and decodes on the card unless the
    caller asks for the CPU: with no device given it takes "cuda", which
    raises without a card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot be shown")
    rng, db, query, masks = world
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PORT.protocol.Coordinator(PORT.masks(masks), [("127.0.0.1", 1)])


def test_party_processes_serve_the_port_coordinator():
    """Participants in processes of their own (``protocol.party_proc``, the
    card check's helper) on the CPU: two keyed parties and the data party,
    each rebuilt from the seed and the key, serve the port's Coordinator on
    the batched, reference and chain wires; the winners equal the JAX
    package's PlaintextEngine on the same DB, and every process stops on
    its SIGTERM with its serving stats."""
    from mpc_iris_tpu.models import PlaintextEngine as JaxPlain
    from mpc_iris_tpu_torch.ops.encode import share_split_device
    from mpc_iris_tpu_torch.protocol.party_proc import start_parties, stop_parties
    from mpc_iris_tpu_torch.smoke_data import db_rng, make_db

    n, seed, key = 40, 5, native.derive_insecure_key(9)
    pat, msk, planted, dup, qpat, qmsk = make_db(db_rng(seed), n)
    want = [(r.index, r.distance) for r in JaxPlain(pat, msk, chunk=8).match(qpat[:8], qmsk[:8])]
    assert [i for i, _ in want] == planted.tolist()
    queries = [PORT.t(Template(a, m)) for a, m in zip(qpat[:8], qmsk[:8])]
    parties = start_parties(n, seed, key, ["cpu"] * 3, chunk=8, timeout=120)

    async def go():
        def addrs(wire):
            return [("127.0.0.1", p["ports"][wire]) for p in parties]

        masks = PORT.masks(msk)
        local = PORT.share(share_split_device(pat, msk, 3, key, device=CPU,
                                              shares=[2])[0])
        chain = PORT.coordinator(masks, addrs("chain")[:2], local_engine=local, chain=True,
                                 strict_scan=True)
        return (await PORT.coordinator(masks, addrs("batched"), strict_scan=True)
                .query_batch(queries),
                [await PORT.coordinator(masks, addrs("reference")).query(queries[0])],
                await chain.query_batch(queries))

    try:
        runs = asyncio.run(go())
    finally:
        reports = stop_parties(parties, timeout=60)
    for outs in runs:
        assert [(o.index, o.distance) for o in outs] == want[:len(outs)]
        assert all(o.total == n for o in outs)
    served = [{w: st["served"] for w, st in r["stats"].items()} for r in reports]
    assert served == [{"reference": 1, "batched": 1, "chain": 1}] * 2 + [
        {"reference": 1, "batched": 1, "chain": 0}]
    assert all(r["share_planes_kernel"] == 0 for r in reports)  # CPU keys never launch
    assert all(p["proc"].returncode == 0 for p in parties)
