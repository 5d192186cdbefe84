"""ctypes bindings for the native C++ codec/ETL core (iris_codec.cpp here, a
byte-for-byte copy of ``mpc_iris_tpu/native/iris_codec.cpp``; this module is a
copy of ``mpc_iris_tpu/native/__init__.py``, built and loaded on its own).

The library is compiled on demand with g++ (no pybind11 in the image; plain C ABI
via ctypes). Every entry point has a NumPy fallback so the framework works without
a toolchain; `available()` reports which path is active.

Covers the reference's Rust runtime hot paths: hex codec (src/bits.rs:74-93),
streaming template JSON parse (src/json_stream.rs; the ~20k templates/s prepare
bottleneck, src/main.rs:312), template render (src/main.rs:186-267), additive
share split (src/encoded_bits.rs:22-38) and share-sum reconstruction
(src/main.rs:598-611).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES

# The C++ source ships INSIDE the package (pyproject package-data) so pip
# installs can still compile it. Build output goes next to the source when
# that directory is writable (repo checkout), else to a per-user cache
# (read-only site-packages). The Makefile builds with -march=native, so the
# library is rebuilt whenever the source is newer than it (a checkout carries
# no build output: build/ is not committed).
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "iris_codec.cpp")


def _host_key() -> str:
    """A key of this host's CPU (architecture, model and feature flags): the
    library is built with -march=native, so a build directory copied to
    another host is never loaded there."""
    import hashlib
    import platform

    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            ident += "".join(sorted({line for line in f
                                     if line.startswith(("model name", "flags"))}))
    except OSError:
        pass
    return hashlib.sha1(ident.encode()).hexdigest()[:12]


def _build_dir() -> str:
    if os.access(_PKG_DIR, os.W_OK):
        return os.path.join(_PKG_DIR, "build", _host_key())
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(cache, "mpc-iris-tpu-torch", "native-build", _host_key())


_SO = os.path.join(_build_dir(), "libiris_codec.so")

_lock = threading.Lock()
_lib = None
_tried = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return True
    try:
        subprocess.run(
            ["make", "-C", os.path.dirname(_SRC),
             f"BUILD={os.path.dirname(_SO)}"],
            check=True,
            capture_output=True,
            timeout=300,
        )
        return os.path.exists(_SO)
    except Exception as e:  # toolchain missing / compile error -> fallback
        print(f"mpc_iris_tpu_torch.native: build failed ({e}); using NumPy fallbacks",
              file=sys.stderr)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        lib = ctypes.CDLL(_SO)
        lib.ic_version.restype = ctypes.c_int
        lib.ic_hex_decode.restype = ctypes.c_int
        lib.ic_hex_decode.argtypes = [_u8p, ctypes.c_int64, _u8p]
        lib.ic_hex_encode.restype = None
        lib.ic_hex_encode.argtypes = [_u8p, ctypes.c_int64, ctypes.c_char_p]
        lib.ic_parse_templates.restype = ctypes.c_int64
        lib.ic_parse_templates.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int, _u8p, _u8p, ctypes.c_int64,
            _i64p, _i32p,
        ]
        lib.ic_rendered_size.restype = ctypes.c_int64
        lib.ic_rendered_size.argtypes = [ctypes.c_int64]
        lib.ic_render_templates.restype = ctypes.c_int64
        lib.ic_render_templates.argtypes = [_u8p, _u8p, ctypes.c_int64, ctypes.c_char_p]
        lib.ic_share_split.restype = None
        lib.ic_share_split.argtypes = [
            _u16p, ctypes.c_int64, ctypes.c_int, _u8p, ctypes.c_int64,
            _u16p,
        ]
        lib.ic_share_sum.restype = None
        lib.ic_share_sum.argtypes = [
            ctypes.POINTER(_u16p), ctypes.c_int, ctypes.c_int64, _u16p,
        ]
        lib.ic_rerandomize.restype = None
        lib.ic_rerandomize.argtypes = [
            _u16p, ctypes.c_int64, _u8p, ctypes.c_int, ctypes.c_int64,
        ]
        lib.ic_chacha20_stream.restype = None
        lib.ic_chacha20_stream.argtypes = [
            _u8p, ctypes.c_uint32, _u8p, ctypes.c_int64, _u8p,
        ]
        lib.ic_encode_u16.restype = None
        lib.ic_encode_u16.argtypes = [_u8p, _u8p, ctypes.c_int64, _u16p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the compiled C++ core is loadable."""
    return _load() is not None


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _as_u16p(a: np.ndarray):
    return a.ctypes.data_as(_u16p)


# ------------------------------------------------------------------ hex codec


def hex_decode(hex_bytes: bytes) -> np.ndarray:
    """Lower/upper hex string bytes -> uint8 array."""
    if len(hex_bytes) % 2:
        raise ValueError("odd-length hex string")
    n = len(hex_bytes) // 2
    lib = _load()
    if lib is None:
        return np.frombuffer(bytes.fromhex(hex_bytes.decode("ascii")), np.uint8).copy()
    src = np.frombuffer(hex_bytes, np.uint8)
    out = np.empty(n, np.uint8)
    if lib.ic_hex_decode(_as_u8p(src), n, _as_u8p(out)) != 0:
        raise ValueError("invalid hex")
    return out


def hex_encode(data: np.ndarray) -> bytes:
    """uint8 array -> lowercase hex bytes."""
    data = np.ascontiguousarray(data, np.uint8).ravel()
    lib = _load()
    if lib is None:
        return data.tobytes().hex().encode("ascii")
    out = ctypes.create_string_buffer(2 * data.size)
    lib.ic_hex_encode(_as_u8p(data), data.size, out)
    return out.raw


# ---------------------------------------------------------- template streaming


class TemplateParser:
    """Incremental parser for template-JSON byte streams (native-accelerated).

    Feed arbitrary byte chunks; collect (patterns, masks) uint8 [n, 1600] batches.
    Semantics match io.json_stream + Template.from_json_obj for well-formed
    reference-format files; malformed input raises ValueError.
    """

    def __init__(self, max_batch: int = 4096):
        self._lib = _load()
        self._state = ctypes.c_int32(0)
        self._tail = b""
        self._done = False
        self.max_batch = max_batch
        if self._lib is None:
            raise RuntimeError("native library unavailable")

    @property
    def finished(self) -> bool:
        return self._done

    def feed(self, data: bytes, final: bool = False):
        """Yield (patterns, masks) batches parsed from buffered + new bytes."""
        buf = self._tail + data
        view = np.frombuffer(buf, np.uint8)
        offset = 0
        while True:
            pats = np.empty((self.max_batch, BITS_BYTES), np.uint8)
            msks = np.empty((self.max_batch, BITS_BYTES), np.uint8)
            consumed = ctypes.c_int64(0)
            remaining = view[offset:]
            n = self._lib.ic_parse_templates(
                _as_u8p(remaining), remaining.size, int(final),
                _as_u8p(pats), _as_u8p(msks), self.max_batch,
                ctypes.byref(consumed), ctypes.byref(self._state),
            )
            if n < 0:
                raise ValueError("malformed template JSON")
            offset += consumed.value
            if n > 0:
                yield pats[:n], msks[:n]
            if self._state.value == 2:
                self._done = True
                self._tail = b""
                return
            if n < self.max_batch:
                break
        if final and not self._done:
            raise ValueError("premature EOF in template JSON")
        self._tail = buf[offset:]


def parse_templates_stream(fp, batch: int = 4096, chunk_size: int = 1 << 22):
    """Yield (patterns, masks) uint8 [n<=batch, 1600] batches from a file object.

    Uses the native streaming parser when available, else the Python
    json_stream fallback.
    """
    lib = _load()
    if lib is None:
        from mpc_iris_tpu_torch.io.formats import read_templates_json

        pats, msks = [], []
        for t in read_templates_json(fp):
            pats.append(t.pattern.data)
            msks.append(t.mask.data)
            if len(pats) == batch:
                yield np.stack(pats), np.stack(msks)
                pats, msks = [], []
        if pats:
            yield np.stack(pats), np.stack(msks)
        return

    parser = TemplateParser(max_batch=batch)
    while True:
        data = fp.read(chunk_size)
        final = not data
        yield from parser.feed(data, final=final)
        if parser.finished:
            return
        if final:
            raise ValueError("premature EOF in template JSON")


def render_templates(patterns: np.ndarray, masks: np.ndarray) -> bytes:
    """Render [n, 1600] planes to the comma-joined pretty JSON objects (no
    surrounding brackets) — byte-identical to io.formats.write_templates_json's
    per-element output."""
    patterns = np.ascontiguousarray(patterns, np.uint8)
    masks = np.ascontiguousarray(masks, np.uint8)
    n = patterns.shape[0]
    lib = _load()
    if lib is None:
        import json

        parts = []
        for p, m in zip(patterns, masks):
            parts.append(json.dumps(
                {"pattern": p.tobytes().hex(), "mask": m.tobytes().hex()},
                indent=2, separators=(",", ": "),
            ))
        return ",".join(parts).encode()
    size = lib.ic_rendered_size(n)
    out = ctypes.create_string_buffer(max(size, 1))
    written = lib.ic_render_templates(_as_u8p(patterns), _as_u8p(masks), n, out)
    return out.raw[:written]


# ---------------------------------------------------------------- ChaCha20
# All share randomness comes from ChaCha20 (RFC 8439) keyed with >=256-bit OS
# entropy — matching the reference's thread_rng CSPRNG (src/encoded_bits.rs:
# 27-33). Streams are *addressable*: (key, stream_id, row) names an independent
# keystream, so output is byte-reproducible regardless of batching/threading
# and two parties can derive identical pairwise streams. The stream-id space is
# partitioned: share index s in [0, 2^32-2] for share_split, 0xFFFFFFFF for
# rerandomize — disjoint even under (discouraged) key reuse.

RERAND_STREAM_ID = 0xFFFFFFFF


def _check_key(key) -> bytes:
    key = bytes(key)
    if len(key) != 32:
        raise ValueError("key must be exactly 32 bytes (use os.urandom(32), "
                         "or derive_insecure_key(seed) for testing)")
    return key


def derive_insecure_key(seed: int) -> bytes:
    """Derive a 32-byte key from a small integer seed — TESTING ONLY.

    A 64-bit seed space is brute-forceable; real share material must be keyed
    from ``os.urandom(32)``. Kept so fixtures/benchmarks are reproducible.
    """
    import hashlib

    return hashlib.sha256(
        b"mpc-iris-tpu/insecure-seed/v1" + (seed & (2**64 - 1)).to_bytes(8, "little")
    ).digest()


_CHACHA_CONST = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                         np.uint32)


def _chacha20_blocks_np(key: bytes, counter0: int, nonce_words, n_blocks: int):
    """n_blocks 64-byte ChaCha20 keystream blocks as uint8 [n_blocks*64].

    Vectorized over blocks; bit-identical to the native ChaCha20 (RFC 8439).
    """
    kw = np.frombuffer(key, "<u4")
    s = np.empty((16, n_blocks), np.uint32)
    s[0:4] = _CHACHA_CONST[:, None]
    s[4:12] = kw[:, None]
    s[12] = (np.uint32(counter0) + np.arange(n_blocks, dtype=np.uint32))
    s[13] = np.uint32(nonce_words[0])
    s[14] = np.uint32(nonce_words[1])
    s[15] = np.uint32(nonce_words[2])
    x = s.copy()

    def rotl(v, k):
        return (v << np.uint32(k)) | (v >> np.uint32(32 - k))

    def qr(a, b, c, d):
        x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl(x[d], 16)
        x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl(x[b], 12)
        x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl(x[d], 8)
        x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl(x[b], 7)

    with np.errstate(over="ignore"):
        for _ in range(10):
            qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15)
            qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14)
        x += s
    # Serialize: per block, 16 LE u32 words in order -> [n_blocks, 64] bytes.
    return np.ascontiguousarray(x.T).astype("<u4").view(np.uint8).reshape(-1)


def chacha20_stream(key, counter: int, nonce12: bytes, nbytes: int) -> np.ndarray:
    """Raw ChaCha20 keystream bytes (RFC 8439; 12-byte nonce, 32-bit counter).

    Native-accelerated with a bit-identical NumPy fallback; exposed so tests
    can pin both against independent implementations and RFC vectors.
    """
    key = _check_key(key)
    if len(nonce12) != 12:
        raise ValueError("nonce must be 12 bytes")
    lib = _load()
    n_blocks = (nbytes + 63) // 64
    if lib is None:
        return _chacha20_blocks_np(
            key, counter, np.frombuffer(nonce12, "<u4"), n_blocks
        )[:nbytes].copy()
    k = np.frombuffer(key, np.uint8)
    nc = np.frombuffer(nonce12, np.uint8)
    out = np.empty(nbytes, np.uint8)
    lib.ic_chacha20_stream(_as_u8p(k), counter & 0xFFFFFFFF, _as_u8p(nc),
                           nbytes, _as_u8p(out))
    return out


def row_stream_u16(key: bytes, stream_id: int, row: int) -> np.ndarray:
    """One row's share keystream as u16 [12800] — the host-side source of
    truth for SPEC §4.1 row addressing (nonce = stream_id:4LE || row:8LE,
    counter 0). Native-accelerated via :func:`chacha20_stream`; shared by
    the share_split/rerandomize fallbacks and the CLI's keyed decrypt view
    so the byte layout lives in exactly one Python-side place."""
    nonce = (stream_id & 0xFFFFFFFF).to_bytes(4, "little") + (
        row & 0xFFFFFFFFFFFFFFFF
    ).to_bytes(8, "little")
    return (
        chacha20_stream(key, 0, nonce, 2 * BITS).view("<u2").astype(np.uint16)
    )



def share_split(enc: np.ndarray, n_shares: int, key, row_offset: int = 0):
    """Additive Z_2^16 share split: u16 [n, 12800] -> u16 [n_shares, n, 12800].

    ``key`` is a 32-byte ChaCha20 key (OS entropy for real use). Deterministic
    per (key, share index, row_offset + row): batching/threading independent.
    Matches the reference's CSPRNG-backed share(n), src/encoded_bits.rs:22-38.
    """
    key = _check_key(key)
    enc = np.ascontiguousarray(enc, np.uint16)
    n = enc.shape[0]
    lib = _load()
    if lib is None:
        out = np.empty((n_shares, n, BITS), np.uint16)
        with np.errstate(over="ignore"):
            for i, row in enumerate(enc):
                total = np.zeros(BITS, np.uint16)
                for s in range(n_shares - 1):
                    v = row_stream_u16(key, s, row_offset + i)
                    out[s, i] = v
                    total += v
                out[n_shares - 1, i] = row - total
        return out
    out = np.empty((n_shares, n, BITS), np.uint16)
    kbuf = np.frombuffer(key, np.uint8)
    lib.ic_share_split(_as_u16p(enc), n, n_shares, _as_u8p(kbuf),
                       row_offset, _as_u16p(out))
    return out


def share_sum(shares) -> np.ndarray:
    """Wrapping u16 sum of N same-shaped share arrays (reconstruction)."""
    arrs = [np.ascontiguousarray(s, np.uint16) for s in shares]
    lib = _load()
    if lib is None:
        total = arrs[0].copy()
        for a in arrs[1:]:
            total += a
        return total
    flat = [a.ravel() for a in arrs]
    out = np.empty_like(flat[0])
    ptrs = (_u16p * len(flat))(*[_as_u16p(a) for a in flat])
    lib.ic_share_sum(ptrs, len(flat), flat[0].size, _as_u16p(out))
    return out.reshape(arrs[0].shape)


def rerandomize(shares: np.ndarray, pair_key, sign: int,
                row_offset: int = 0) -> np.ndarray:
    """Refresh a share matrix in place with a pairwise zero-sum ChaCha20 stream.

    Two parties sharing the 32-byte ``pair_key`` apply opposite ``sign``; the
    noise cancels in reconstruction while each stored share becomes a fresh
    uniform value (the reference spec's "re-randomization via correlated PRNGs"
    future work). Streams are keyed by (key, RERAND_STREAM_ID, row_offset +
    row): batch-size independent, and observed noise reveals nothing about
    other rows' streams. Returns the (mutated) array.

    The NumPy fallback is bit-identical to the native ChaCha20 (pinned by
    tests), so mixed native/fallback parties still cancel exactly.
    """
    pair_key = _check_key(pair_key)
    shares = np.ascontiguousarray(shares, np.uint16)
    if shares.ndim != 2 or shares.shape[1] != BITS:
        raise ValueError(f"expected [n, {BITS}] u16 shares, got {shares.shape}")
    if not shares.flags.writeable:
        # In-place semantics: a silent copy would discard the refresh; writing
        # through the raw pointer into read-only (memmap) pages segfaults.
        raise ValueError("rerandomize requires a writeable array (copy memmap "
                         "slices first)")
    lib = _load()
    if lib is None:
        with np.errstate(over="ignore"):
            for i in range(shares.shape[0]):
                ks = row_stream_u16(pair_key, RERAND_STREAM_ID, row_offset + i)
                if sign >= 0:
                    shares[i] += ks
                else:
                    shares[i] -= ks
        return shares
    kbuf = np.frombuffer(pair_key, np.uint8)
    lib.ic_rerandomize(_as_u16p(shares), shares.shape[0],
                       _as_u8p(kbuf), 1 if sign >= 0 else -1,
                       row_offset)
    return shares


def encode_u16_native(patterns: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Packed planes [n, 1600] -> ring encoding u16 [n, 12800]
    (enc = mask - 2*(pattern & mask) per bit, reference src/lib.rs:16-26)."""
    patterns = np.ascontiguousarray(patterns, np.uint8)
    masks = np.ascontiguousarray(masks, np.uint8)
    n = patterns.shape[0]
    lib = _load()
    if lib is None:
        import torch

        from mpc_iris_tpu_torch.ops.encode import encode_grid_u16, unpack_bits

        # the port's encode on CPU tensors: int32 in [0, 2^16) (torch has no
        # uint16 arithmetic on the CPU), narrowed to u16 at the host edge
        p = unpack_bits(torch.from_numpy(patterns))
        m = unpack_bits(torch.from_numpy(masks))
        return encode_grid_u16(p, m).numpy().astype(np.uint16).reshape(n, BITS)
    out = np.empty((n, BITS), np.uint16)
    lib.ic_encode_u16(_as_u8p(patterns), _as_u8p(masks), n, _as_u16p(out))
    return out
