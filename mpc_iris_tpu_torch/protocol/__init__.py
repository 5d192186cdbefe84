"""The N-party match protocol over TCP on PyTorch (counterpart of
``mpc_iris_tpu/protocol``).

Wire format parity with the reference (src/main.rs:405-445, 486-560), byte
for byte with the JAX package's roles, so either package's coordinator
serves the other's participants:

- query: the raw 3,200-byte template (pattern plane then mask plane);
- reply: a stream of 62-byte records, 31 little-endian u16 dot shares per DB
  entry, in DB order, terminated by connection close (``wire.py`` adds the
  batched and chain extensions);
- topology: the coordinator fans out one connection per participant per
  query and sums the per-party u16 shares to reconstruct plaintext
  distances (the only place they exist).

Device compute (the port's engines) runs in worker threads feeding asyncio
queues, so network streaming overlaps the device chunk scans; the
coordinator uploads each received round from pinned memory and decodes it on
its device (``Coordinator(..., device=)``).
"""

from mpc_iris_tpu_torch.protocol.coordinator import (
    Coordinator,
    MatchAt,
    PersistentQueryClient,
    QueryOutcome,
    QueryServer,
    StalledPartyError,
    TruncatedScanError,
    UnderThresholdOutcome,
    _frac_less_host,
    _sum_decode_argmin_device,
    _sum_decode_argmin_device_batch,
    _sum_decode_minfrac_device,
    _sum_decode_minfrac_device_batch,
    query_remote,
    query_remote_under,
)
from mpc_iris_tpu_torch.protocol.participant import ParticipantServer

__all__ = [
    "ParticipantServer",
    "Coordinator",
    "MatchAt",
    "PersistentQueryClient",
    "QueryOutcome",
    "UnderThresholdOutcome",
    "QueryServer",
    "StalledPartyError",
    "TruncatedScanError",
    "query_remote",
    "query_remote_under",
    "_frac_less_host",
    "_sum_decode_argmin_device",
    "_sum_decode_argmin_device_batch",
    "_sum_decode_minfrac_device",
    "_sum_decode_minfrac_device_batch",
]
