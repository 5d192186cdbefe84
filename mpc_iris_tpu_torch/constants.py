"""Domain constants for the iris-code model (copy of ``mpc_iris_tpu/constants.py``).

Values match the reference exactly (src/lib.rs:10-12): an iris code is a 64x200 grid
of masked bits, 12,800 bits total.
"""

# Grid geometry (reference: src/lib.rs:10-12).
COLS: int = 200
ROWS: int = 4 * 16  # 64
BITS: int = ROWS * COLS  # 12,800

# Packed sizes (reference: src/bits.rs:10-15, src/encoded_bits.rs:13-15).
ROW_BYTES: int = COLS // 8  # 25 bytes per 200-bit grid row
BITS_BYTES: int = BITS // 8  # 1,600 bytes per packed bit plane
ENCODED_BYTES: int = 2 * BITS  # 25,600 bytes per u16-encoded vector
TEMPLATE_BYTES: int = 2 * BITS_BYTES  # 3,200 bytes: pattern plane then mask plane

# Rotation range: the matching distance is the minimum over column rotations
# r in [-15, +15] of the query (reference: src/template.rs:43-47, src/lib.rs:33-40).
MAX_ROTATION: int = 15
ROTATIONS: tuple = tuple(range(-MAX_ROTATION, MAX_ROTATION + 1))
N_ROTATIONS: int = len(ROTATIONS)  # 31

# Reply record: one little-endian u16 per rotation per DB entry
# (reference: src/main.rs:428-434).
REPLY_RECORD_BYTES: int = 2 * N_ROTATIONS  # 62
