"""Reference-compatible binary and JSON template stores (copy of
``mpc_iris_tpu/io/formats.py``).

- ``*.masks``: concatenated 1,600-byte packed mask planes (src/main.rs:294-301).
- ``*.share-i``: concatenated 25,600-byte little-endian u16 share vectors
  (src/main.rs:302-309). 1M entries = 25.6 GB per party.
- template JSON: pretty-printed array of {"pattern": hex, "mask": hex}
  (src/main.rs:196-213).

Binary stores are consumed zero-copy via ``np.memmap`` (the reference mmaps + casts,
src/main.rs:386-400) so DBs far larger than RAM stream straight into device transfers.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator

import numpy as np

from mpc_iris_tpu_torch.constants import BITS, BITS_BYTES
from mpc_iris_tpu_torch.io.json_stream import iter_json_array
from mpc_iris_tpu_torch.types import Template


# ------------------------------------------------------------------ binary stores


def open_masks(path) -> np.ndarray:
    """Memory-map a masks file as uint8 [N, 1600]."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"masks file {path} is empty")
    if size % BITS_BYTES:
        raise ValueError(f"masks file {path} is not a whole number of records")
    n = size // BITS_BYTES
    return np.memmap(path, dtype=np.uint8, mode="r", shape=(n, BITS_BYTES))


def open_share(path) -> np.ndarray:
    """Memory-map a share file as little-endian u16 [N, 12800]."""
    size = os.path.getsize(path)
    rec = 2 * BITS
    if size == 0:
        raise ValueError(f"share file {path} is empty")
    if size % rec:
        raise ValueError(f"share file {path} is not a whole number of records")
    n = size // rec
    return np.memmap(path, dtype="<u2", mode="r", shape=(n, BITS))


def write_masks(path, masks: np.ndarray) -> None:
    """Append-write packed mask planes uint8 [N, 1600]."""
    with open(path, "ab") as f:
        f.write(np.ascontiguousarray(masks, dtype=np.uint8).tobytes())


def write_share(path, shares: np.ndarray) -> None:
    """Append-write share vectors u16 [N, 12800] as little-endian."""
    with open(path, "ab") as f:
        f.write(np.ascontiguousarray(shares).astype("<u2").tobytes())


# ------------------------------------------------------------------ JSON store


def write_templates_json(fp, templates: Iterable[Template], pretty: bool = True) -> int:
    """Stream templates to an open binary file as a JSON array; returns the count.

    With ``pretty``, objects use a 2-space indent. NOTE: this is this
    framework's canonical layout, NOT byte-identical to the reference's
    serde_json pretty printer (which also indents the array brackets/commas);
    interop with reference-generated files is at the JSON level — both readers
    parse either layout.
    """
    fp.write(b"[")
    count = 0
    for t in templates:
        if count:
            fp.write(b",")
        obj = t.to_json_obj()
        if pretty:
            fp.write(
                json.dumps(obj, indent=2, separators=(",", ": ")).encode()
            )
        else:
            fp.write(json.dumps(obj, separators=(",", ":")).encode())
        count += 1
    fp.write(b"]\n")
    return count


def read_templates_json(fp) -> Iterator[Template]:
    """Stream-parse a template JSON array from an open binary file."""
    for obj in iter_json_array(fp):
        yield Template.from_json_obj(obj)
