"""The card's published peaks, and the card line printed beside them.

Frozen copies of ``mpc_iris_tpu_torch/benchmarks.py``'s ``HBM_BYTES_PER_S``,
``INT8_OPS`` and ``card_line``. The peaks are NVIDIA's H100 SXM data
sheet, dense: 3.35 TB/s of HBM3 and 1,979 TOP/s of int8 tensor operations,
at the full 700 W; a card set to a lower power limit runs below them, so
``card_line`` is printed beside every run's numbers.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT8_OPS = 1.979e15


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or why
    there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.strip().splitlines()[0]

