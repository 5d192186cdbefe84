"""Storage formats and streaming ingest (copy of ``mpc_iris_tpu/io``).

Byte-compatible with the reference's formats (SURVEY.md section 2 "Storage & wire
formats"): raw concatenated records consumed by memory-mapping (`np.memmap` standing in
for the reference's mmap + bytemuck casts, src/main.rs:386-400, 455-469), and the
pretty-printed JSON template dump with hex-encoded planes (src/main.rs:196,
src/bits.rs:74-93).
"""

from mpc_iris_tpu_torch.io.formats import (
    open_masks,
    open_share,
    read_templates_json,
    write_masks,
    write_share,
    write_templates_json,
)
from mpc_iris_tpu_torch.io.json_stream import iter_json_array

__all__ = [
    "open_masks",
    "open_share",
    "read_templates_json",
    "write_masks",
    "write_share",
    "write_templates_json",
    "iter_json_array",
]
