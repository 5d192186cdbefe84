"""CLI helpers: SI-suffixed counts and a device banner (counterpart of
``mpc_iris_tpu/utils/config.py``; ``parse_si`` is a copy).

The reference prints a CPU-feature banner and parses counts like "1M"
(src/main.rs:96, 168-176); here the banner reports torch, CUDA and the cards.
The JAX package's persistent compile cache has no counterpart: the port's
kernels are built once per source hash (``ops/_build.py``).
"""

from __future__ import annotations

_SI = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}


def parse_si(s: str) -> int:
    """Parse '1M', '100k', '3000000' into an int."""
    s = s.strip()
    if s and s[-1] in _SI:
        return int(float(s[:-1]) * _SI[s[-1]])
    return int(s)


def device_banner(devices=None) -> str:
    """torch's and CUDA's versions, each visible card's name, and the devices
    a role runs on (``devices``, a list of ``torch.device``)."""
    import torch

    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    line = (f"torch {torch.__version__} cuda {torch.version.cuda or 'none'} "
            f"cards={len(cards)}" + (f" ({', '.join(sorted(set(cards)))})" if cards else ""))
    if devices is not None:
        line += f" devices=[{', '.join(str(d) for d in devices)}]"
    return line
