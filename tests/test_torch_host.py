"""The port's host layer (mpc_iris_tpu_torch.types.EncodedBits, .io, .native,
.utils) against the JAX package's: the cases of test_io.py, test_native.py
(without its sanitizer gate), test_types.py's EncodedBits and
test_profiling.py run through the port, and files written by either package
are byte-equal. The port's iris_codec.cpp and Makefile are byte-for-byte
the JAX package's, built to the port's own build directory, and its NumPy
fallbacks equal its C++ core."""

import filecmp
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_iris_tpu import native as ref_native
from mpc_iris_tpu.io import formats as ref_formats
from mpc_iris_tpu.types import EncodedBits as RefEncodedBits
from mpc_iris_tpu.types import Template as RefTemplate
from mpc_iris_tpu_torch import native
from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES, COLS, ROWS
from mpc_iris_tpu_torch.io.formats import (
    open_masks,
    open_share,
    read_templates_json,
    write_masks,
    write_share,
    write_templates_json,
)
from mpc_iris_tpu_torch.io.json_stream import JsonStreamError, iter_json_array
from mpc_iris_tpu_torch.types import Bits, EncodedBits, Template
from mpc_iris_tpu_torch.utils.profiling import (
    annotate,
    device_memory_stats,
    device_trace,
)

ROOT = Path(__file__).resolve().parent.parent


def _planes(rng, n):
    pats = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    msks = rng.integers(0, 256, (n, 1600), dtype=np.uint8)
    return pats, msks


def _ref(t: Template) -> RefTemplate:
    return RefTemplate.from_bytes(t.to_bytes())


# ------------------------------------------------------------------ io (test_io.py)


class TestJsonStream:
    def _parse(self, s, **kw):
        return list(iter_json_array(io.BytesIO(s.encode()), **kw))

    def test_basic(self):
        assert self._parse('[1, 2, 3]') == [1, 2, 3]
        assert self._parse('[]') == []
        assert self._parse('[ ]') == []
        assert self._parse('[{"a": 1}, {"b": [2, 3]}]') == [{"a": 1}, {"b": [2, 3]}]

    def test_strings_with_specials(self):
        assert self._parse('["a,b", "c]d", "e\\"f"]') == ["a,b", "c]d", 'e"f']

    def test_nested(self):
        assert self._parse('[[1,[2]],{"x":{"y":[3]}}]') == [[1, [2]], {"x": {"y": [3]}}]

    def test_small_chunks(self):
        data = json.dumps([{"k": "v" * 50, "n": i} for i in range(20)])
        out = list(iter_json_array(io.BytesIO(data.encode()), chunk_size=7))
        assert out == json.loads(data)

    def test_errors(self):
        for bad in ("", "{", "[1, 2", "[1,, 2]", "[1 2]", "[1,]"):
            with pytest.raises(JsonStreamError):
                self._parse(bad)

    def test_whitespace_pretty(self):
        data = json.dumps([{"a": i} for i in range(5)], indent=2)
        assert self._parse(data) == [{"a": i} for i in range(5)]


class TestFormats:
    def test_templates_json_roundtrip(self, rng, tmp_path):
        ts = [Template.random(rng) for _ in range(7)]
        path = tmp_path / "t.json"
        with open(path, "wb") as f:
            assert write_templates_json(f, ts) == 7
        with open(path) as f:
            plain = json.load(f)
        assert len(plain) == 7 and set(plain[0]) == {"pattern", "mask"}
        with open(path, "rb") as f:
            back = list(read_templates_json(f))
        assert back == ts
        # byte-equal to the JAX package's writer, and readable by its reader
        ref_path = tmp_path / "ref.json"
        with open(ref_path, "wb") as f:
            ref_formats.write_templates_json(f, [_ref(t) for t in ts])
        assert path.read_bytes() == ref_path.read_bytes()
        with open(path, "rb") as f:
            assert list(ref_formats.read_templates_json(f)) == [_ref(t) for t in ts]

    def test_masks_share_roundtrip(self, rng, tmp_path):
        masks = rng.integers(0, 256, size=(5, BITS_BYTES), dtype=np.uint8)
        shares = rng.integers(0, 1 << 16, size=(5, BITS), dtype=np.uint16)
        mp, sp = tmp_path / "x.masks", tmp_path / "x.share-0"
        write_masks(mp, masks)
        write_share(sp, shares)
        assert mp.stat().st_size == 5 * BITS_BYTES
        assert sp.stat().st_size == 5 * 2 * BITS
        np.testing.assert_array_equal(open_masks(mp), masks)
        np.testing.assert_array_equal(open_share(sp), shares)
        rmp, rsp = tmp_path / "r.masks", tmp_path / "r.share-0"
        ref_formats.write_masks(rmp, masks)
        ref_formats.write_share(rsp, shares)
        assert filecmp.cmp(mp, rmp, shallow=False) and filecmp.cmp(sp, rsp, shallow=False)

    def test_share_file_record_layout(self, rng, tmp_path):
        """First record's bytes are the EncodedBits LE serialization."""
        e = EncodedBits.random(rng)
        sp = tmp_path / "y.share-0"
        write_share(sp, e.data[None])
        assert sp.read_bytes() == e.to_bytes() == RefEncodedBits(e.data).to_bytes()

    def test_invalid_sizes(self, tmp_path):
        p = tmp_path / "bad.masks"
        p.write_bytes(b"\x00" * 100)
        with pytest.raises(ValueError):
            open_masks(p)
        with pytest.raises(ValueError):
            open_share(p)


class TestCliPipeline:
    def test_generate_prepare_decrypt(self, tmp_path):
        from mpc_iris_tpu_torch.cli import main

        db = tmp_path / "db.json"
        assert main(["generate", str(db), "12", "--seed", "3"]) == 0
        with open(db, "rb") as f:
            templates = list(read_templates_json(f))
        assert len(templates) == 12

        base = tmp_path / "mpc"
        assert main(["prepare", str(db), "3", str(base), "--insecure-seed", "4",
                     "--batch", "5"]) == 0
        masks = open_masks(f"{base}.masks")
        assert masks.shape[0] == 12
        np.testing.assert_array_equal(masks[4], templates[4].mask.data)

        # share sum reconstructs the ring encoding
        shares = [open_share(f"{base}.share-{i}") for i in range(3)]
        total = sum(s[7].astype(np.int64) for s in shares) & 0xFFFF
        t = templates[7]
        np.testing.assert_array_equal(
            total, native.encode_u16_native(t.pattern.data[None], t.mask.data[None])[0])

        out = tmp_path / "dec.json"
        assert main(["decrypt"] + [f"{base}.share-{i}" for i in range(3)]
                    + ["--output", str(out), "--batch", "5"]) == 0
        with open(out, "rb") as f:
            decoded = list(read_templates_json(f))
        assert len(decoded) == 12
        for d, t in zip(decoded, templates):
            assert d.mask == t.mask
            assert (d.pattern & d.mask) == (t.pattern & t.mask)

    def test_generate_no_overwrite(self, tmp_path):
        from mpc_iris_tpu_torch.cli import main

        db = tmp_path / "db.json"
        db.write_text("[]")
        assert main(["generate", str(db), "1"]) == 1
        assert main(["generate", str(db), "1", "--replace", "--seed", "0"]) == 0


# ------------------------------------------------------------------ types (test_types.py)


class TestEncodedBits:
    def test_rotated_number(self):
        vals = np.array(
            [(row << 8 | col) for row in range(ROWS) for col in range(COLS)],
            dtype=np.uint16,
        )
        secret = EncodedBits(vals)
        for amount in range(-15, 16):
            rot = secret.rotated(amount)
            np.testing.assert_array_equal(rot.data, RefEncodedBits(vals).rotated(amount).data)
            for i in (0, 1, 37, 199, 200, 12799, 6400):
                row, col = divmod(i, COLS)
                src_col = (col - amount) % COLS
                assert rot.data[i] == (row << 8 | src_col), (amount, i)

    def test_rotated_inverse(self, rng):
        e = EncodedBits.random(rng)
        for amount in range(-15, 16):
            assert e.rotated(amount).rotated(-amount) == e

    def test_rotated_bits_equivalence(self, rng):
        b = Bits.random(rng)
        e = EncodedBits.from_bits(b)
        for amount in (-15, -3, 0, 5, 15):
            assert EncodedBits.from_bits(b.rotated(amount)) == e.rotated(amount)

    def test_share_reconstruct(self, rng):
        e = EncodedBits.random(rng)
        for n in (1, 2, 3, 5):
            shares = e.share(n, rng)
            assert len(shares) == n
            assert EncodedBits.reconstruct(shares) == e
        assert e.share(1, rng)[0] == e
        # the same generator state draws the same shares as the JAX package
        got = EncodedBits(e.data).share(3, np.random.default_rng(5))
        want = RefEncodedBits(e.data).share(3, np.random.default_rng(5))
        assert [s.data.tobytes() for s in got] == [s.data.tobytes() for s in want]

    def test_share_invalid(self, rng):
        with pytest.raises(ValueError):
            EncodedBits.random(rng).share(0)

    def test_dot_oracle(self, rng):
        a = EncodedBits.random(rng)
        b = EncodedBits.random(rng)
        want = int((a.data.astype(np.int64) * b.data.astype(np.int64)).sum() & 0xFFFF)
        assert a.dot(b) == want == RefEncodedBits(a.data).dot(RefEncodedBits(b.data))

    def test_ring_ops_wrap(self, rng):
        a, b = EncodedBits.random(rng), EncodedBits.random(rng)
        assert (a + b) - b == a
        assert -(-a) == a
        assert (a - b) + b == a
        s = a + b
        assert np.array_equal(s.data, (a.data.astype(np.uint32) + b.data) & 0xFFFF)
        ra, rb = RefEncodedBits(a.data), RefEncodedBits(b.data)
        for got, want in (((a * b), (ra * rb)), ((a - b), (ra - rb)), ((-a), (-ra))):
            np.testing.assert_array_equal(got.data, want.data)

    def test_sum_wraps(self):
        e = EncodedBits(np.full(BITS, 0xFFFF, dtype=np.uint16))
        assert e.sum() == (0xFFFF * BITS) & 0xFFFF

    def test_bytes_roundtrip_le(self, rng):
        e = EncodedBits.random(rng)
        raw = e.to_bytes()
        assert len(raw) == 2 * BITS
        assert raw[0] == e.data[0] & 0xFF and raw[1] == e.data[0] >> 8
        assert EncodedBits.from_bytes(raw) == e
        assert raw == RefEncodedBits(e.data).to_bytes()

    def test_size_validation(self):
        with pytest.raises(ValueError):
            EncodedBits(np.zeros(10, np.uint16))


def test_template_json_equals_jax_package(rng):
    t = Template.random(rng)
    assert t.to_json_obj() == _ref(t).to_json_obj()
    assert Template.from_json(_ref(t).to_json()) == t
    assert Bits.from_hex(t.pattern.to_hex()) == t.pattern


# ------------------------------------------------------------------ native (test_native.py)


def test_native_sources_are_the_jax_packages():
    """The C++ core and its Makefile are byte-for-byte the JAX package's;
    the port builds them into its own directory, keyed to this host."""
    for name in ("iris_codec.cpp", "Makefile"):
        assert filecmp.cmp(ROOT / "mpc_iris_tpu_torch" / "native" / name,
                           ROOT / "mpc_iris_tpu" / "native" / name, shallow=False), name
    assert native.available()
    port_dir = ROOT / "mpc_iris_tpu_torch" / "native" / "build"
    assert Path(native._SO).resolve().is_relative_to(port_dir)
    assert Path(native._SO).parent.name == native._host_key()


def test_hex_roundtrip(rng):
    data = rng.integers(0, 256, 4321, dtype=np.uint8)
    h = native.hex_encode(data)
    assert h == data.tobytes().hex().encode()
    assert np.array_equal(native.hex_decode(h), data)
    assert np.array_equal(native.hex_decode(h.upper()), data)
    with pytest.raises(ValueError):
        native.hex_decode(b"zx")
    with pytest.raises(ValueError):
        native.hex_decode(b"abc")


def test_render_matches_python_writer(rng):
    pats, msks = _planes(rng, 5)
    buf = io.BytesIO()
    write_templates_json(buf, [Template(Bits(p), Bits(m)) for p, m in zip(pats, msks)])
    nat = b"[" + native.render_templates(pats, msks) + b"]\n"
    assert buf.getvalue() == nat
    assert native.render_templates(pats, msks) == ref_native.render_templates(pats, msks)


@pytest.mark.parametrize("chunk_size", [137, 1 << 14])
def test_parse_stream_chunked(rng, chunk_size):
    pats, msks = _planes(rng, 9)
    buf = io.BytesIO()
    write_templates_json(buf, [Template(Bits(p), Bits(m)) for p, m in zip(pats, msks)])
    buf.seek(0)
    got = list(native.parse_templates_stream(buf, batch=4, chunk_size=chunk_size))
    assert all(p.shape[0] <= 4 for p, _ in got)
    assert np.array_equal(np.concatenate([p for p, _ in got]), pats)
    assert np.array_equal(np.concatenate([m for _, m in got]), msks)


def test_parse_accepts_reordered_fields_and_whitespace(rng):
    pats, msks = _planes(rng, 2)
    objs = [
        {"mask": m.tobytes().hex(), "pattern": p.tobytes().hex()}
        for p, m in zip(pats, msks)
    ]
    raw = ("  [ " + " , ".join(json.dumps(o) for o in objs) + " ]\n").encode()
    got = list(native.parse_templates_stream(io.BytesIO(raw)))
    assert np.array_equal(np.concatenate([p for p, _ in got]), pats)
    assert np.array_equal(np.concatenate([m for _, m in got]), msks)


def test_parse_rejects_malformed():
    with pytest.raises(ValueError):
        list(native.parse_templates_stream(io.BytesIO(b'{"not": "array"}')))
    with pytest.raises(ValueError):
        list(native.parse_templates_stream(io.BytesIO(b'[{"pattern": "ab"}]')))
    with pytest.raises(ValueError):  # premature EOF
        list(native.parse_templates_stream(io.BytesIO(b"[")))


K1 = native.derive_insecure_key(123)
K2 = native.derive_insecure_key(124)


def test_share_split_sums_to_encoding_and_is_batch_invariant(rng):
    assert K1 == ref_native.derive_insecure_key(123)
    enc = rng.integers(0, 1 << 16, (6, BITS), dtype=np.uint16)
    shares = native.share_split(enc, 4, K1)
    assert shares.shape == (4, 6, BITS)
    assert np.array_equal(native.share_sum(list(shares)), enc)
    np.testing.assert_array_equal(shares, ref_native.share_split(enc, 4, K1))
    a = native.share_split(enc[:2], 4, K1, row_offset=0)
    b = native.share_split(enc[2:], 4, K1, row_offset=2)
    assert np.array_equal(np.concatenate([a, b], axis=1), shares)
    other = native.share_split(enc, 4, K2)
    assert not np.array_equal(other, shares)
    assert np.array_equal(native.share_sum(list(other)), enc)
    with pytest.raises(ValueError):
        native.share_split(enc, 4, b"short")


def test_share_randomness_is_uniformish(rng):
    enc = np.zeros((4, BITS), dtype=np.uint16)
    shares = native.share_split(enc, 3, native.derive_insecure_key(7))
    r = shares[0].astype(np.float64)
    assert abs(r.mean() - 32767.5) < 300  # ~4 sigma for 51200 samples
    assert all(int((shares[0] >> b & 1).sum()) > 0 for b in range(16))


def test_encode_u16_matches_jax_package_and_fallback(rng, monkeypatch):
    from mpc_iris_tpu.ops.encode import encode_grid_u16, unpack_bits

    pats, msks = _planes(rng, 3)
    ref = encode_grid_u16(
        unpack_bits(pats, xp=np), unpack_bits(msks, xp=np), xp=np
    ).reshape(3, BITS).astype(np.uint16)
    assert np.array_equal(native.encode_u16_native(pats, msks), ref)
    # the fallback goes through the port's ops.encode on CPU tensors
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    fb = native.encode_u16_native(pats, msks)
    assert fb.dtype == np.uint16 and np.array_equal(fb, ref)


def test_parse_rejects_duplicate_keys(rng):
    p = rng.integers(0, 256, 1600, dtype=np.uint8).tobytes().hex()
    raw = ('[{"pattern": "%s", "pattern": "%s"}]' % (p, p)).encode()
    with pytest.raises(ValueError):
        list(native.parse_templates_stream(io.BytesIO(raw)))


def test_parser_fuzz_no_crash(rng):
    """Mutated/truncated inputs must either parse or raise ValueError."""
    pats, msks = _planes(rng, 3)
    base = bytearray(b"[" + native.render_templates(pats, msks) + b"]\n")
    for trial in range(300):
        buf = bytearray(base)
        kind = trial % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 6))):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        elif kind == 1:
            buf = buf[: int(rng.integers(0, len(buf)))]
        else:
            pos = int(rng.integers(0, len(buf)))
            buf[pos:pos] = bytes(rng.integers(0, 256, int(rng.integers(1, 4)),
                                              dtype=np.uint8))
        try:
            for p, m in native.parse_templates_stream(io.BytesIO(bytes(buf)),
                                                      chunk_size=257):
                assert p.shape[1] == 1600 and m.shape[1] == 1600
        except ValueError:
            pass


def test_rerandomize_zero_sum_and_refresh(rng):
    enc = rng.integers(0, 1 << 16, (5, BITS), dtype=np.uint16)
    shares = native.share_split(enc, 3, native.derive_insecure_key(11))
    s0, s1, s2 = (s.copy() for s in shares)
    A, B, C = (native.derive_insecure_key(s) for s in (101, 202, 303))
    native.rerandomize(s0, A, +1)
    native.rerandomize(s0, B, +1)
    native.rerandomize(s1, A, -1)
    native.rerandomize(s1, C, +1)
    native.rerandomize(s2, B, -1)
    native.rerandomize(s2, C, -1)
    assert np.array_equal(native.share_sum([s0, s1, s2]), enc)
    for old, new in zip(shares, (s0, s1, s2)):
        assert not np.array_equal(old, new)
    t0 = shares[0].copy()
    native.rerandomize(t0[:2], A, +1, row_offset=0)
    native.rerandomize(t0[2:], A, +1, row_offset=2)
    u0 = shares[0].copy()
    native.rerandomize(u0, A, +1)
    assert np.array_equal(t0, u0)
    r0 = shares[0].copy()
    ref_native.rerandomize(r0, A, +1)
    assert np.array_equal(r0, u0)
    read_only = np.frombuffer(bytes(2 * BITS), np.uint16).reshape(1, BITS)
    with pytest.raises(ValueError, match="writeable"):
        native.rerandomize(read_only, A, +1)


def test_chacha20_vs_openssl_and_rfc_scalar():
    from test_native import _chacha20_scalar, _openssl_chacha20

    key = bytes(range(32))
    nonce = bytes([0, 0, 0, 9, 0, 0, 0, 0x4A, 0, 0, 0, 0])  # RFC 8439 2.3.2
    for counter, n in [(1, 64), (0, 64), (0, 25600), (7, 100)]:
        got = native.chacha20_stream(key, counter, nonce, n)
        assert np.array_equal(got, _openssl_chacha20(key, counter, nonce, n))
        assert got.tobytes() == _chacha20_scalar(key, counter, nonce, n)
    got = native.chacha20_stream(key, 2**32 - 2, nonce, 130)
    assert got.tobytes() == _chacha20_scalar(key, 2**32 - 2, nonce, 130)
    assert native.chacha20_stream(key, 1, nonce, 4).tobytes() == bytes.fromhex("10f1e7e4")


def test_chacha20_numpy_fallback_bit_identical():
    key = bytes(range(1, 33))
    nonce = bytes(range(12))
    nat = native.chacha20_stream(key, 5, nonce, 333)
    fb = native._chacha20_blocks_np(key, 5, np.frombuffer(nonce, "<u4"), (333 + 63) // 64)[:333]
    assert np.array_equal(nat, fb)
    assert np.array_equal(nat, ref_native.chacha20_stream(key, 5, nonce, 333))


def test_share_split_stream_is_addressed_chacha(rng):
    """Share s of global row R is ChaCha20(key, nonce=[s, R], ctr=0), equal
    to the port's device keystream (ops.chacha.share_rows) too."""
    from mpc_iris_tpu_torch.ops.chacha import key_tensor, share_rows
    from test_native import _chacha20_scalar

    enc = rng.integers(0, 1 << 16, (3, BITS), dtype=np.uint16)
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    shares = native.share_split(enc, 3, key, row_offset=40)
    total = np.zeros_like(enc)
    kw = key_tensor(key, torch.device("cpu"))
    for s in range(2):
        for r in range(3):
            nonce = np.array([s, 40 + r, 0], "<u4").tobytes()
            want = np.frombuffer(_chacha20_scalar(key, 0, nonce, 2 * BITS), "<u2")
            assert np.array_equal(shares[s, r], want), (s, r)
        np.testing.assert_array_equal(
            share_rows(kw, s, 40, 3).numpy().astype(np.uint16), shares[s])
        total = (total + shares[s]).astype(np.uint16)
    assert np.array_equal(shares[2], (enc - total).astype(np.uint16))


def test_share_split_and_rerandomize_fallback_parity(rng, monkeypatch):
    """The port's NumPy fallbacks equal its C++ core bit for bit."""
    enc = rng.integers(0, 1 << 16, (4, BITS), dtype=np.uint16)
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    pair = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    pats, msks = _planes(rng, 3)
    nat_shares = native.share_split(enc, 3, key, row_offset=9)
    nat_rr = nat_shares[0].copy()
    native.rerandomize(nat_rr, pair, -1, row_offset=9)
    nat_hex = native.hex_encode(pats[0])
    nat_render = native.render_templates(pats, msks)
    nat_sum = native.share_sum(list(nat_shares))
    blob = b"[" + nat_render + b"]\n"
    nat_parse = list(native.parse_templates_stream(io.BytesIO(blob), batch=2))

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    fb_shares = native.share_split(enc, 3, key, row_offset=9)
    fb_rr = nat_shares[0].copy()
    native.rerandomize(fb_rr, pair, -1, row_offset=9)
    assert np.array_equal(fb_shares, nat_shares)
    assert np.array_equal(fb_rr, nat_rr)
    assert native.hex_encode(pats[0]) == nat_hex
    assert np.array_equal(native.hex_decode(nat_hex), pats[0])
    assert native.render_templates(pats, msks) == nat_render
    assert np.array_equal(native.share_sum(list(nat_shares)), nat_sum)
    fb_parse = list(native.parse_templates_stream(io.BytesIO(blob), batch=2))
    for (gp, gm), (wp, wm) in zip(fb_parse, nat_parse, strict=True):
        assert np.array_equal(gp, wp) and np.array_equal(gm, wm)


def test_rerandomize_stream_disjoint_from_share_streams(rng):
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    enc = np.zeros((1, BITS), np.uint16)
    shares = native.share_split(enc, 2, key)
    noise = np.zeros((1, BITS), np.uint16)
    native.rerandomize(noise, key, +1)
    assert not np.array_equal(noise[0], shares[0, 0])


# ------------------------------------------------------------------ utils (test_profiling.py)


def test_device_trace_writes_files(tmp_path):
    out = str(tmp_path / "trace")
    with device_trace(out):
        with annotate("test-region"):
            (torch.arange(128) * 2).sum().item()
    files = [os.path.join(r, f) for r, _, fs in os.walk(out) for f in fs]
    assert files, "no trace files written"
    trace = json.loads(Path(out, "trace.json").read_text())
    assert any(e.get("name") == "test-region" for e in trace["traceEvents"])


def test_device_memory_stats_shape():
    stats = device_memory_stats(torch.device("cpu"))
    assert stats == {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
    if not torch.cuda.is_available():
        assert device_memory_stats() == stats


def test_utils_copies_equal_jax_package():
    from mpc_iris_tpu.utils import config as ref_config
    from mpc_iris_tpu.utils import stats as ref_stats
    from mpc_iris_tpu_torch.utils import config, stats
    from mpc_iris_tpu_torch.utils.progress import Progress

    for s in ("1M", "100k", "3000000", "2.5k", " 7 "):
        assert config.parse_si(s) == ref_config.parse_si(s)
    samples = [0.5, 0.51, 0.49, 0.52, 3.0, 0.5]
    assert stats.summarize_timings(samples) == ref_stats.summarize_timings(samples)
    assert stats.summarize_timings(samples[:3]) == ref_stats.summarize_timings(samples[:3])
    buf = io.StringIO()
    p = Progress("x", total=4, unit="t", stream=buf)
    p.update(4, 100)
    p.finish()
    assert buf.getvalue().startswith("x: 4 /4")
    assert "torch" in config.device_banner([torch.device("cpu")])
    s = stats.summarize_timings(samples)
    assert stats.format_summary(s, "ms", 1e3) == ref_stats.format_summary(s, "ms", 1e3)
