"""Host-side value types: a packed bit plane, a Z_2^16 vector and a plaintext
template.

Copies of ``mpc_iris_tpu/types/bits.py::Bits``,
``mpc_iris_tpu/types/encoded.py::EncodedBits`` and
``mpc_iris_tpu/types/template.py::Template``, so the port needs nothing of the
JAX package. Byte layout: 1,600 bytes per plane, bit ``i`` at byte ``i // 8``,
position ``i % 8`` (LSB-first); a template is the pattern plane then the mask
plane; an ``EncodedBits`` is 12,800 little-endian u16 values (25,600 bytes),
row-major over the 64 x 200 grid. JSON form of a template:
``{"pattern": "<hex>", "mask": "<hex>"}``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from mpc_iris_tpu_torch.constants import (
    BITS,
    BITS_BYTES,
    COLS,
    MAX_ROTATION,
    ROWS,
    TEMPLATE_BYTES,
)


class Bits:
    """Packed bit plane: an owned ``np.uint8`` array of 1,600 bytes (mirrors
    ``mpc_iris_tpu.types.bits.Bits``). ``rotated(amount)`` shifts every
    200-bit grid row so that new column ``j`` holds old column
    ``(j - amount) mod 200``, i.e. ``np.roll(grid, amount, axis=-1)``."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray | bytes | None = None):
        if data is None:
            self.data = np.zeros(BITS_BYTES, dtype=np.uint8)
        else:
            arr = np.frombuffer(data, dtype=np.uint8).copy() if isinstance(
                data, (bytes, bytearray, memoryview)
            ) else np.asarray(data, dtype=np.uint8).reshape(-1).copy()
            if arr.size != BITS_BYTES:
                raise ValueError(f"Bits requires {BITS_BYTES} bytes, got {arr.size}")
            self.data = arr

    def to_bytes(self) -> bytes:
        return self.data.tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Bits":
        return cls(raw)

    def to_hex(self) -> str:
        """Lowercase hex of the raw bytes."""
        return self.data.tobytes().hex()

    @classmethod
    def from_hex(cls, s: str) -> "Bits":
        return cls(bytes.fromhex(s))

    def grid(self) -> np.ndarray:
        """Unpacked view as a bool [64, 200] grid (bit i -> [i//200, i%200])."""
        return np.unpackbits(self.data, bitorder="little").astype(bool).reshape(ROWS, COLS)

    @classmethod
    def from_grid(cls, grid: np.ndarray) -> "Bits":
        grid = np.asarray(grid)
        if grid.shape != (ROWS, COLS):
            raise ValueError(f"grid must be [{ROWS}, {COLS}], got {grid.shape}")
        return cls(np.packbits(grid.astype(bool).reshape(-1), bitorder="little"))

    def rotate(self, amount: int) -> None:
        self.data = self.rotated(amount).data

    def rotated(self, amount: int) -> "Bits":
        if amount % COLS == 0:
            return Bits(self.data)
        return Bits.from_grid(np.roll(self.grid(), amount, axis=1))

    def count_ones(self) -> int:
        return int(np.unpackbits(self.data).sum())

    def dot(self, other: "Bits") -> int:
        """AND-popcount ``popcount(self & other)``."""
        return int(np.unpackbits(self.data & other.data).sum())

    def __and__(self, other: "Bits") -> "Bits":
        return Bits(self.data & other.data)

    def __or__(self, other: "Bits") -> "Bits":
        return Bits(self.data | other.data)

    def __xor__(self, other: "Bits") -> "Bits":
        return Bits(self.data ^ other.data)

    def __invert__(self) -> "Bits":
        return Bits(~self.data)

    def __getitem__(self, index: int) -> bool:
        if not 0 <= index < BITS:
            raise IndexError(index)
        return bool((self.data[index >> 3] >> (index & 7)) & 1)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Bits) and bool(np.array_equal(self.data, other.data))

    def __hash__(self) -> int:
        return hash(self.data.tobytes())

    def __repr__(self) -> str:
        return f"Bits({self.to_hex()[:32]}...)"

    @classmethod
    def random(cls, rng: np.random.Generator | None = None) -> "Bits":
        rng = rng if rng is not None else np.random.default_rng()
        return cls(rng.integers(0, 256, size=BITS_BYTES, dtype=np.uint8))


class EncodedBits:
    """Z_2^16 vector: an owned ``np.uint16`` array of 12,800 values, the unit
    of secret sharing (mirrors ``mpc_iris_tpu.types.encoded.EncodedBits``).
    Every ring op wraps mod 2^16; ``share(n)`` is n-1 uniform vectors and the
    wrapping difference; ``rotated`` rolls each 200-value grid row."""

    __slots__ = ("data",)

    def __init__(self, data: np.ndarray | None = None):
        if data is None:
            self.data = np.zeros(BITS, dtype=np.uint16)
        else:
            arr = np.asarray(data).reshape(-1)
            if arr.size != BITS:
                raise ValueError(f"EncodedBits requires {BITS} values, got {arr.size}")
            self.data = arr.astype(np.uint16).copy()

    def to_bytes(self) -> bytes:
        """25,600 bytes, little-endian u16s (the share file's record)."""
        return self.data.astype("<u2").tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "EncodedBits":
        return cls(np.frombuffer(raw, dtype="<u2").astype(np.uint16))

    def grid(self) -> np.ndarray:
        """View as a [64, 200] u16 grid."""
        return self.data.reshape(ROWS, COLS)

    def share(self, n: int, rng: np.random.Generator | None = None) -> list["EncodedBits"]:
        """Split into ``n`` additive shares summing to ``self`` mod 2^16."""
        if n <= 0:
            raise ValueError("n must be positive")
        rng = rng if rng is not None else np.random.default_rng()
        shares = [
            EncodedBits(rng.integers(0, 1 << 16, size=BITS, dtype=np.uint16))
            for _ in range(n - 1)
        ]
        total = np.zeros(BITS, dtype=np.uint16)
        for s in shares:
            total += s.data  # uint16 wraps mod 2^16 in NumPy
        shares.append(EncodedBits(self.data - total))
        return shares

    @classmethod
    def reconstruct(cls, shares: list["EncodedBits"]) -> "EncodedBits":
        """Wrapping sum of shares, the inverse of :meth:`share`."""
        total = np.zeros(BITS, dtype=np.uint16)
        for s in shares:
            total += s.data
        return cls(total)

    def rotate(self, amount: int) -> None:
        self.data = self.rotated(amount).data

    def rotated(self, amount: int) -> "EncodedBits":
        if amount % COLS == 0:
            return EncodedBits(self.data)
        return EncodedBits(np.roll(self.grid(), amount, axis=1).reshape(-1))

    def sum(self) -> int:
        """Wrapping sum of all lanes."""
        return int(np.sum(self.data, dtype=np.uint64) & 0xFFFF)

    def dot(self, other: "EncodedBits") -> int:
        """Wrapping-u16 dot product, accumulated in int64 and reduced mod 2^16."""
        prod = self.data.astype(np.int64) * other.data.astype(np.int64)
        return int(np.sum(prod) & 0xFFFF)

    def __add__(self, other: "EncodedBits") -> "EncodedBits":
        return EncodedBits(self.data + other.data)

    def __sub__(self, other: "EncodedBits") -> "EncodedBits":
        return EncodedBits(self.data - other.data)

    def __mul__(self, other: "EncodedBits") -> "EncodedBits":
        return EncodedBits(self.data * other.data)

    def __neg__(self) -> "EncodedBits":
        return EncodedBits(np.zeros(BITS, dtype=np.uint16) - self.data)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, EncodedBits) and bool(
            np.array_equal(self.data, other.data)
        )

    def __hash__(self) -> int:
        return hash(self.data.tobytes())

    def __repr__(self) -> str:
        return f"EncodedBits({self.data[:8]}...)"

    @classmethod
    def from_bits(cls, bits: Bits) -> "EncodedBits":
        """0/1 lift of a bit plane."""
        return cls(np.unpackbits(bits.data, bitorder="little").astype(np.uint16))

    @classmethod
    def random(cls, rng: np.random.Generator | None = None) -> "EncodedBits":
        rng = rng if rng is not None else np.random.default_rng()
        return cls(rng.integers(0, 1 << 16, size=BITS, dtype=np.uint16))


@dataclass
class Template:
    """A plaintext iris code: pattern plane plus validity mask plane (mirrors
    ``mpc_iris_tpu.types.template.Template``). :meth:`distance` is the scalar
    oracle every engine is held to."""

    pattern: Bits = field(default_factory=Bits)
    mask: Bits = field(default_factory=Bits)

    def to_bytes(self) -> bytes:
        """3,200-byte wire form: pattern then mask (reference src/main.rs:419)."""
        return self.pattern.data.tobytes() + self.mask.data.tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Template":
        if len(raw) != TEMPLATE_BYTES:
            raise ValueError(f"Template requires {TEMPLATE_BYTES} bytes, got {len(raw)}")
        return cls(Bits(raw[:BITS_BYTES]), Bits(raw[BITS_BYTES:]))

    def to_json_obj(self) -> dict:
        return {"pattern": self.pattern.to_hex(), "mask": self.mask.to_hex()}

    @classmethod
    def from_json_obj(cls, obj: dict) -> "Template":
        return cls(Bits.from_hex(obj["pattern"]), Bits.from_hex(obj["mask"]))

    def to_json(self) -> str:
        return json.dumps(self.to_json_obj())

    @classmethod
    def from_json(cls, s: str) -> "Template":
        return cls.from_json_obj(json.loads(s))

    def rotate(self, amount: int) -> None:
        self.pattern.rotate(amount)
        self.mask.rotate(amount)

    def rotated(self, amount: int) -> "Template":
        return Template(self.pattern.rotated(amount), self.mask.rotated(amount))

    def fraction_hamming(self, other: "Template") -> float:
        """Masked fractional Hamming distance at rotation 0, in f64; 0/0 is NaN
        (mirrors ``Template.fraction_hamming``)."""
        m = self.mask.data & other.mask.data
        p = (self.pattern.data ^ other.pattern.data) & m
        num = int(np.unpackbits(p).sum())
        den = int(np.unpackbits(m).sum())
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(np.float64(num) / np.float64(den))

    def distance(self, other: "Template") -> float:
        """Minimum :meth:`fraction_hamming` over query rotations r in
        [-15, 15]; NaN terms are skipped, all-NaN gives +inf (mirrors
        ``Template.distance``)."""
        best = float("inf")
        for r in range(-MAX_ROTATION, MAX_ROTATION + 1):
            d = self.rotated(r).fraction_hamming(other)
            if d < best:  # NaN compares false, so NaN is skipped like f64::min
                best = d
        return best

    @classmethod
    def random(cls, rng: np.random.Generator | None = None) -> "Template":
        rng = rng if rng is not None else np.random.default_rng()
        return cls(Bits.random(rng), Bits.random(rng))

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, Template) and self.pattern == other.pattern
                and self.mask == other.mask)
