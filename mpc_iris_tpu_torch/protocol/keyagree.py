"""X25519 pairwise key agreement for share re-randomization (copy of
``mpc_iris_tpu/protocol/keyagree.py``).

The reference spec sketches re-randomization via "correlated PRNGs + DH" as
future work (specification.ipynb, "Iriscode SMPC v1" security notes; no code
exists in the reference). The correlated-PRNG half is the `rerandomize` role
(pairwise zero-sum ChaCha20 streams, native.rerandomize, SPEC §4.2); this
module supplies the DH half: each party generates a long-lived X25519
identity, exchanges 32-byte public keys out of band (SSH/WireGuard style),
and derives the 256-bit pairwise stream key as

    k_ij = HKDF-SHA256(X25519(priv_i, pub_j),
                       salt = min(pub_i, pub_j) || max(pub_i, pub_j),
                       info = b"mpc-iris-tpu/pair-key/v1/" + context)

X25519 is commutative and the salt orders the public keys, so k_ij == k_ji
by construction — both parties derive the same key without any secret ever
crossing the wire. The `context` label domain-separates epochs (e.g. a
refresh round id), so long-lived identities still yield fresh stream keys
per re-randomization round.

Requires the `cryptography` package for the X25519/HKDF primitives; every
entry point degrades to a clear error when it is absent (the rerandomize
role itself keeps working with externally provisioned `--pair J:KEY` keys).
"""

from __future__ import annotations

import os

_INFO_PREFIX = b"mpc-iris-tpu/pair-key/v1/"


def have_crypto() -> bool:
    """True when the optional `cryptography` dependency is importable."""
    try:
        from cryptography.hazmat.primitives.asymmetric import x25519  # noqa: F401
        return True
    except ImportError:
        return False


def _require_crypto():
    if not have_crypto():
        raise RuntimeError(
            "X25519 key agreement needs the `cryptography` package; install "
            "it, or provision pairwise keys externally via rerandomize "
            "--pair J:KEY"
        )


def generate_identity(path: str) -> bytes:
    """Create an X25519 identity at `path` (hex private key, mode 0600) and
    `path + '.pub'` (hex public key). Returns the 32 public-key bytes."""
    _require_crypto()
    from cryptography.hazmat.primitives.asymmetric import x25519

    priv = x25519.X25519PrivateKey.generate()
    priv_raw = _private_bytes(priv)
    pub_raw = _public_bytes(priv.public_key())
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(priv_raw.hex() + "\n")
    with open(path + ".pub", "w") as f:
        f.write(pub_raw.hex() + "\n")
    return pub_raw


def load_identity_public(path: str) -> bytes:
    """Public-key bytes of the identity stored at `path`."""
    _require_crypto()
    from cryptography.hazmat.primitives.asymmetric import x25519

    priv = x25519.X25519PrivateKey.from_private_bytes(read_key32(path))
    return _public_bytes(priv.public_key())


def derive_pair_key(identity_path: str, peer_public: bytes,
                    context: bytes = b"") -> bytes:
    """The 256-bit pairwise stream key shared with the peer whose public key
    is `peer_public` (32 bytes). Symmetric: either side derives the same
    key. Feed the result to `rerandomize --pair J:KEY` / native.rerandomize.
    """
    _require_crypto()
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import x25519
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    if len(peer_public) != 32:
        raise ValueError(f"peer public key must be 32 bytes, got {len(peer_public)}")
    priv = x25519.X25519PrivateKey.from_private_bytes(read_key32(identity_path))
    my_public = _public_bytes(priv.public_key())
    if my_public == peer_public:
        raise ValueError("peer public key equals own public key")
    shared = priv.exchange(x25519.X25519PublicKey.from_public_bytes(peer_public))
    a, b = sorted((my_public, peer_public))
    return HKDF(
        algorithm=hashes.SHA256(), length=32, salt=a + b,
        info=_INFO_PREFIX + context,
    ).derive(shared)


def parse_public(text: str) -> bytes:
    """Accept a 64-hex-char public key, or a path to a `.pub`/hex file."""
    s = text.strip()
    if os.path.exists(s):
        with open(s) as f:
            s = f.read().strip()
    try:
        raw = bytes.fromhex(s)
    except ValueError:
        raise ValueError(f"not a hex public key or readable key file: {text!r}")
    if len(raw) != 32:
        raise ValueError(f"public key must be 32 bytes (64 hex chars), got {len(raw)}")
    return raw


def read_key32(path: str) -> bytes:
    """Read a 256-bit key file: 64 hex digits in byte order (what
    `pair-key --out` writes), or the `0x`-prefixed little-endian-integer
    form the CLI prints / `--pair J:KEY` accepts inline — both decode to
    the same bytes, so a hand-copied printed key cannot silently become
    its byte-reversal."""
    with open(path) as f:
        text = f.read().strip()
    if text.lower().startswith("0x"):
        val = int(text, 16)
        if val >= 2**256:
            raise ValueError(f"{path}: 0x key exceeds 256 bits")
        return val.to_bytes(32, "little")
    raw = bytes.fromhex(text)
    if len(raw) != 32:
        raise ValueError(f"{path}: expected 32 hex-encoded key bytes, got {len(raw)}")
    return raw


def _private_bytes(priv) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return priv.private_bytes(
        serialization.Encoding.Raw, serialization.PrivateFormat.Raw,
        serialization.NoEncryption(),
    )


def _public_bytes(pub) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return pub.public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw,
    )
