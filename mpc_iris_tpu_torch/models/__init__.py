"""Match engines on PyTorch (counterpart of ``mpc_iris_tpu/models``): the
plaintext engine over a packed or dense device-resident template DB."""

from mpc_iris_tpu_torch.models.engines import (
    MatchResult,
    PlaintextEngine,
    prepare_query_planes,
)

__all__ = ["MatchResult", "PlaintextEngine", "prepare_query_planes"]
