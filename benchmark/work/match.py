"""Work of one ``match`` request, from the shapes alone.

- ``db_bytes``: the packed DB read once, 3,200 bytes an entry (the least any
  design moves; the answer is a few numbers).
- ``int8_ops``: the two products of the int8 formulation (numerator dot and
  denominator), 2 operations a multiply-add, over 31 rotation rows a query,
  12,800 bits and every entry.
- ``comparisons``: queries x entries, each over its 31 rotations.
"""

BITS = 12_800
ROTATIONS = 31
ENTRY_BYTES = 3_200  # packed pattern and mask planes


def work(config: dict, traffic: dict) -> dict:
    n, b = int(config["entries"]), int(traffic["batch"])
    db_bytes = n * ENTRY_BYTES
    return {
        "db_bytes": db_bytes,
        "request_bytes": db_bytes,
        "int8_ops": 2 * 2 * b * ROTATIONS * BITS * n,
        "comparisons": b * n,
    }
