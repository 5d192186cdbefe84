"""Match engines on PyTorch (counterpart of ``mpc_iris_tpu/models``): the
plaintext engine over a packed or dense device-resident template DB, with
the min-distance match and the threshold audit."""

from mpc_iris_tpu_torch.models.engines import (
    AuditLimitExceeded,
    MatchResult,
    PlaintextEngine,
    prepare_query_planes,
)

__all__ = ["AuditLimitExceeded", "MatchResult", "PlaintextEngine", "prepare_query_planes"]
