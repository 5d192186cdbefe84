"""Work of one keyed party request, from the shapes alone.

- ``share_bytes``: the resident int8 lo and hi share planes read once,
  25,600 bytes an entry.
- ``reply_bytes``: the reply, 31 u16 values an entry and query, written once.
- ``int8_ops``: the lo and hi products, 2 operations a multiply-add, over 31
  rotation rows a query, 12,800 lanes and every entry.
- ``comparisons``: queries x entries.
"""

BITS = 12_800
ROTATIONS = 31


def work(config: dict, traffic: dict) -> dict:
    n, b = int(config["entries"]), int(traffic["batch"])
    share_bytes = n * 2 * BITS
    reply_bytes = n * b * ROTATIONS * 2
    return {
        "share_bytes": share_bytes,
        "reply_bytes": reply_bytes,
        "request_bytes": share_bytes + reply_bytes,
        "int8_ops": 2 * 2 * b * ROTATIONS * BITS * n,
        "comparisons": b * n,
    }
