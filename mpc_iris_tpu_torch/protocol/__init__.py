"""The MPC protocol on PyTorch (counterpart of ``mpc_iris_tpu/protocol``).

For now only the coordinator's device steps: the share sum and the distance
decode (:mod:`mpc_iris_tpu_torch.protocol.coordinator`). The asyncio roles
(``ParticipantServer``, ``Coordinator``) and ``wire``, ``pump`` and ``drain``
follow with the CLI; meanwhile the JAX package's roles serve the port's
engines, which they touch only through ``.stream``, ``.refresh`` and
``.count``.
"""

from mpc_iris_tpu_torch.protocol.coordinator import (
    _frac_less_host,
    _sum_decode_argmin_device,
    _sum_decode_argmin_device_batch,
    _sum_decode_minfrac_device,
    _sum_decode_minfrac_device_batch,
)

__all__ = [
    "_frac_less_host",
    "_sum_decode_argmin_device",
    "_sum_decode_argmin_device_batch",
    "_sum_decode_minfrac_device",
    "_sum_decode_minfrac_device_batch",
]
