"""The port's share-path ops (mpc_iris_tpu_torch.ops: ChaCha20 keystream
regeneration, the u16 ring encoding and share split, the exact mod-2^16
share dots) against the JAX package's, the RFC 8439 vector, the
`cryptography` package and the C++ core, on the same numpy inputs, on the
CPU. Every comparison is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_iris_tpu import native
from mpc_iris_tpu.constants import BITS, BITS_BYTES
from mpc_iris_tpu.ops import chacha as jcha
from mpc_iris_tpu.ops import dot as jdot
from mpc_iris_tpu.ops import encode as jenc
from mpc_iris_tpu_torch.ops import chacha as tcha
from mpc_iris_tpu_torch.ops import dot as tdot
from mpc_iris_tpu_torch.ops import encode as tenc

RFC_KEY = bytes(range(32))
RFC_NONCE = bytes.fromhex("000000090000004a00000000")
RFC_BLOCK1 = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
HIGH_KEY = native.derive_insecure_key(12345)  # sha256 bytes: high bits set


def _kw(key):
    return tcha.key_tensor(key, "cpu")


def _np(planes):
    return [p.numpy() for p in planes]


# ------------------------------------------------------------------ keystream


def test_keystream_rfc8439_vector():
    assert tcha.keystream_bytes(RFC_KEY, 1, RFC_NONCE, 64) == RFC_BLOCK1


def test_keystream_matches_cryptography_package():
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    key, nonce12, counter = bytes(range(1, 33)), b"\x07" * 12, 5
    enc = Cipher(algorithms.ChaCha20(key, counter.to_bytes(4, "little") + nonce12),
                 mode=None).encryptor()
    assert tcha.keystream_bytes(key, counter, nonce12, 1000) == enc.update(b"\x00" * 1000)


def test_keystream_matches_native_core():
    key = bytes(range(2, 34))
    nonce12 = (123).to_bytes(4, "little") + (2**33 + 7).to_bytes(8, "little")
    got = tcha.keystream_bytes(key, 0, nonce12, 777)
    assert got == bytes(memoryview(native.chacha20_stream(key, 0, nonce12, 777)))
    assert got == jcha.keystream_bytes(key, 0, nonce12, 777)


def test_rfc_vector_through_row_addressing():
    """Stream id 0x09000000, row 0x4a000000 is the RFC nonce; block 1 of that
    row, as file-order bytes, is the RFC keystream, in share_rows and in the
    natural planes."""
    rows = tcha.share_rows(_kw(RFC_KEY), 0x09000000, 0x4a000000, 1).numpy()
    assert rows.astype("<u2").tobytes()[64:128] == RFC_BLOCK1
    lo, hi = tcha.share_planes_natural(_kw(RFC_KEY), 0x09000000, 0x4a000000, 1)
    u16 = tdot.planes_to_shares(lo, hi)[0].numpy()
    words = [int(u16[w * 400 + 1]) | int(u16[6400 + w * 400 + 1]) << 16 for w in range(16)]
    assert np.array(words, "<u4").tobytes() == RFC_BLOCK1


# ------------------------------------------------------------------ share rows and planes


def test_share_rows_match_native_share_split():
    rng = np.random.default_rng(3)
    enc = rng.integers(0, 1 << 16, size=(5, BITS), dtype=np.uint16)
    key = native.derive_insecure_key(42)
    out = native.share_split(enc, 3, key, row_offset=7)
    for s in range(2):
        np.testing.assert_array_equal(tcha.share_rows(_kw(key), s, 7, 5).numpy(), out[s])
    np.testing.assert_array_equal(
        tcha.share_rows(_kw(key), 1, 3, 4).numpy(),
        np.asarray(jcha.share_rows(tcha.key_words(key), 1, 3, 4)))


@pytest.mark.parametrize("row0", [0xFFFFFF80, 0xFFFFFFC0, 0xFFFFFFF0])
def test_natural_planes_equal_jax_and_pallas_interpret(row0):
    """The plain ChaCha equals the JAX XLA emitter and the Pallas word
    kernel (interpret mode) at 128 rows: no carry, a carry from a tile base,
    a carry mid-tile; the largest valid stream id and a high-bit key."""
    assert any(b & 0x80 for b in HIGH_KEY[3::4])
    sid = 0xFFFFFFFE
    got = _np(tcha.share_planes_natural(_kw(HIGH_KEY), sid, row0, 128))
    kw = jnp.asarray(jcha.key_words(HIGH_KEY))
    ref = jcha.share_planes_natural(kw, np.uint32(sid), np.uint32(row0), 128)
    pal = jcha.share_planes_natural_pallas(kw, np.uint32(sid), np.uint32(row0), 128,
                                           interpret=True)
    for g, r, p in zip(got, ref, pal):
        np.testing.assert_array_equal(g, np.asarray(r))
        np.testing.assert_array_equal(g, np.asarray(p))


def test_natural_planes_are_permuted_file_planes():
    pi = tcha.k_permutation()
    assert sorted(pi.tolist()) == list(range(BITS))
    np.testing.assert_array_equal(pi, jcha.k_permutation())
    kw = _kw(RFC_KEY)
    lo_f, hi_f = _np(tdot.shares_to_planes(tcha.share_rows(kw, 2, 5, 3)))
    lo_n, hi_n = _np(tcha.share_planes_natural(kw, 2, 5, 3))
    np.testing.assert_array_equal(lo_n, lo_f[:, pi])
    np.testing.assert_array_equal(hi_n, hi_f[:, pi])
    # the kernel wrapper takes the plain version for a key on the CPU
    for a, b in zip(_np(tcha.share_planes_kernel(kw, 2, 5, 3)), (lo_n, hi_n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad", [-1, 0xFFFFFFFF, 2**40])
def test_check_stream_id_rejects(bad):
    with pytest.raises(ValueError, match="stream id"):
        tcha.check_stream_id(bad)
    with pytest.raises(ValueError, match="stream id"):
        jcha.check_stream_id(bad)


def test_row_offset_out_of_range_raises():
    with pytest.raises(ValueError, match="row offset"):
        tcha.share_rows(_kw(RFC_KEY), 0, 2**32, 1)


# ------------------------------------------------------------------ encode and split


def test_encode_grid_u16_equals_jax():
    rng = np.random.default_rng(9)
    p = rng.integers(0, 2, (4, BITS), dtype=np.uint8)
    m = rng.integers(0, 2, (4, BITS), dtype=np.uint8)
    got = tenc.encode_grid_u16(torch.from_numpy(p), torch.from_numpy(m)).numpy()
    assert set(np.unique(got)) <= {0, 1, 0xFFFF}
    np.testing.assert_array_equal(got, np.asarray(jenc.encode_grid_u16(p, m)))


@pytest.mark.parametrize("n_shares,row_offset,chunk", [
    (2, 0, 4),
    (3, 0x7FFFFFFA, 4),   # chunks on both sides of 2^31
    (3, 0xFFFFFFF8, 16),  # one chunk whose rows cross 2^32 (the nonce carry)
])
def test_share_split_device_equals_jax_and_native(n_shares, row_offset, chunk):
    rng = np.random.default_rng(n_shares)
    pat = rng.integers(0, 256, (11, BITS_BYTES), dtype=np.uint8)
    msk = rng.integers(0, 256, (11, BITS_BYTES), dtype=np.uint8)
    key = native.derive_insecure_key(77)
    got = tenc.share_split_device(pat, msk, n_shares, key, row_offset,
                                  device="cpu", chunk=chunk)
    assert got.dtype == np.uint16 and got.shape == (n_shares, 11, BITS)
    if row_offset < 2**31:  # the JAX function takes an int32 row offset
        ref = np.asarray(jenc.share_split_device(pat, msk, n_shares, key, row_offset))
        np.testing.assert_array_equal(got, ref)
    enc = jenc.encode_grid_u16(jenc.unpack_bits(pat, xp=np), jenc.unpack_bits(msk, xp=np),
                               xp=np)
    np.testing.assert_array_equal(got, native.share_split(enc, n_shares, key, row_offset))
    np.testing.assert_array_equal(native.share_sum(list(got)), enc)
    last = tenc.share_split_device(pat, msk, n_shares, key, row_offset, device="cpu",
                                   chunk=chunk, shares=[n_shares - 1])
    np.testing.assert_array_equal(last[0], got[-1])


# ------------------------------------------------------------------ share dots


def _extreme_shares(rng, n):
    s = rng.integers(0, 1 << 16, size=(n, BITS)).astype(np.uint16)
    s[0, :] = 0xFFFF
    s[1, :] = 0x8000
    s[2, :2] = [0, 0xFFFF]
    return s


def test_planes_round_trip():
    s = _extreme_shares(np.random.default_rng(4), 6)
    for src in (torch.from_numpy(s.view(np.int16)), torch.from_numpy(s.astype(np.int32))):
        lo, hi = tdot.shares_to_planes(src)
        assert lo.dtype == hi.dtype == torch.int8
        jlo, jhi = jdot.shares_to_planes(s)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(tdot.planes_to_shares(lo, hi).numpy(), s)


def test_dot_share_batch_equals_jax_and_oracle():
    rng = np.random.default_rng(5)
    q = rng.integers(-1, 2, size=(7, BITS)).astype(np.int8)
    q[0] = 1  # the largest positive rowsum
    q[1] = -1
    s = _extreme_shares(rng, 5)
    lo, hi = tdot.shares_to_planes(torch.from_numpy(s.view(np.int16)))
    got = tdot.dot_share_batch(torch.from_numpy(q), lo, hi).numpy()
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() <= 0xFFFF
    jlo, jhi = jdot.shares_to_planes(s)
    np.testing.assert_array_equal(got, np.asarray(jdot.dot_share_batch(q, jlo, jhi)))
    for i in range(q.shape[0]):
        for j in range(s.shape[0]):
            assert got[i, j] == tdot.dot_u16_oracle(q[i], s[j]) == jdot.dot_u16_oracle(q[i], s[j])
