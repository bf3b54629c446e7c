"""Compute ops: step-loop recurrences, banded attention and the
hand-written CUDA kernels."""

from .attention_kernels import (  # noqa: F401
    banded_attention_dkv,
    banded_attention_dq,
    banded_attention_fwd,
    banded_flash_attention,
    fused_attention_fwd,
    fused_attention_layer,
)
from .lstm import (  # noqa: F401
    bidirectional_lstm,
    init_lstm_params,
    lstm_scan,
    lstm_step,
    reverse_padded,
)
from .lstm_kernels import (  # noqa: F401
    fused_lstm_recurrence,
    lstm_recurrence,
    lstm_recurrence_bwd,
    lstm_recurrence_bwd_reference,
    lstm_recurrence_reference,
)
