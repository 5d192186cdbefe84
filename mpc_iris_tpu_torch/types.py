"""Host-side value types: a packed bit plane and a plaintext template.

Copies of ``mpc_iris_tpu/types/bits.py::Bits`` and
``mpc_iris_tpu/types/template.py::Template`` (the parts the port uses), so the
port needs nothing of the JAX package. Byte layout: 1,600 bytes per plane, bit
``i`` at byte ``i // 8``, position ``i % 8`` (LSB-first); a template is the
pattern plane then the mask plane.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mpc_iris_tpu_torch.constants import BITS_BYTES, COLS, MAX_ROTATION, ROWS, TEMPLATE_BYTES


class Bits:
    """Packed bit plane: an owned ``np.uint8`` array of 1,600 bytes (mirrors
    ``mpc_iris_tpu.types.bits.Bits``)."""

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

    def grid(self) -> np.ndarray:
        """Unpacked view as a bool [64, 200] grid (bit i -> [i//200, i%200])."""
        return np.unpackbits(self.data, bitorder="little").astype(bool).reshape(ROWS, COLS)

    @classmethod
    def from_grid(cls, grid: np.ndarray) -> "Bits":
        grid = np.asarray(grid)
        if grid.shape != (ROWS, COLS):
            raise ValueError(f"grid must be [{ROWS}, {COLS}], got {grid.shape}")
        return cls(np.packbits(grid.astype(bool).reshape(-1), bitorder="little"))

    def rotated(self, amount: int) -> "Bits":
        """Every 200-bit grid row rotated: new column ``j`` holds old column
        ``(j - amount) mod 200``, i.e. ``np.roll(grid, amount, axis=-1)``."""
        if amount % COLS == 0:
            return Bits(self.data)
        return Bits.from_grid(np.roll(self.grid(), amount, axis=1))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Bits) and bool(np.array_equal(self.data, other.data))

    def __hash__(self) -> int:
        return hash(self.data.tobytes())

    @classmethod
    def random(cls, rng: np.random.Generator | None = None) -> "Bits":
        rng = rng if rng is not None else np.random.default_rng()
        return cls(rng.integers(0, 256, size=BITS_BYTES, dtype=np.uint8))


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
