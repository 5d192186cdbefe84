"""Incremental JSON-array reader (copy of ``mpc_iris_tpu/io/json_stream.py``):
multi-GB template dumps never materialize in RAM.

Equivalent of the reference's hand-rolled `iter_json_array` (src/json_stream.rs:27-58):
scan ``[`` / ``,`` / ``]`` tokens and deserialize one element at a time. This version
scans buffered chunks with a small state machine (string/escape/depth tracking) so the
per-element cost is one `json.loads` over the element's bytes.
"""

from __future__ import annotations

import json
from typing import Iterator

_WS = frozenset((0x20, 0x09, 0x0D, 0x0A))


class JsonStreamError(ValueError):
    pass


def iter_json_array(fp, chunk_size: int = 1 << 20) -> Iterator[object]:
    """Yield decoded elements of a JSON array from a binary file object.

    Raises JsonStreamError on malformed input (mirroring the reference's
    invalid-data errors, src/json_stream.rs:15-17, 33-49).
    """
    buf = bytearray()
    pos = 0

    def refill(keep_from: int) -> int:
        """Drop bytes before keep_from, read more; returns the shift applied.
        Raises on EOF."""
        nonlocal buf, pos
        shift = keep_from
        if shift:
            del buf[:shift]
            pos -= shift
        data = fp.read(chunk_size)
        if not data:
            raise JsonStreamError("premature EOF")
        buf.extend(data)
        return shift

    def next_nonws() -> int:
        """Byte value at scan position, skipping whitespace (not consumed)."""
        nonlocal pos
        while True:
            while pos < len(buf):
                if buf[pos] in _WS:
                    pos += 1
                else:
                    return buf[pos]
            refill(pos)

    if next_nonws() != 0x5B:  # [
        raise JsonStreamError("`[` not found")
    pos += 1

    first = True
    while True:
        b = next_nonws()
        if b == 0x5D:  # ]
            return
        if not first:
            if b != 0x2C:  # ,
                raise JsonStreamError("`,` or `]` not found")
            pos += 1
            b = next_nonws()
            if b == 0x5D:
                raise JsonStreamError("trailing comma")
        first = False

        # Scan one JSON value: string/escape state and bracket depth.
        start = pos
        depth = 0
        in_str = False
        escape = False
        done = False
        while not done:
            if pos >= len(buf):
                start -= refill(start)
            c = buf[pos]
            if in_str:
                if escape:
                    escape = False
                elif c == 0x5C:  # backslash
                    escape = True
                elif c == 0x22:  # quote
                    in_str = False
            elif c == 0x22:
                in_str = True
            elif c in (0x7B, 0x5B):  # { [
                depth += 1
            elif c in (0x7D, 0x5D):  # } ]
                if depth == 0:
                    if c == 0x7D:
                        raise JsonStreamError("unbalanced `}`")
                    done = True  # the array's closing ] after a bare scalar
                    break
                depth -= 1
                if depth == 0:
                    pos += 1
                    done = True
                    break
            elif depth == 0 and c == 0x2C:  # , terminates a bare scalar
                done = True
                break
            pos += 1

        raw = bytes(buf[start:pos]).strip()
        if not raw:
            raise JsonStreamError("empty element")
        try:
            yield json.loads(raw)
        except json.JSONDecodeError as e:
            raise JsonStreamError(f"bad element: {e}") from e
