"""Compute ops: step-loop recurrences, banded attention, LayerNorm and the
hand-written CUDA kernels."""

from .attention_kernels import (  # noqa: F401
    banded_attention_dkv,
    banded_attention_dq,
    banded_attention_fwd,
    banded_flash_attention,
    fused_attention_fwd,
    fused_attention_layer,
)
from .layernorm_kernels import (  # noqa: F401
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_fwd_reference,
)
from .lstm import (  # noqa: F401
    bidirectional_lstm,
    init_lstm_params,
    lstm_scan,
    lstm_step,
    reverse_padded,
)
from .lstm_kernels import (  # noqa: F401
    bilstm_grid_bwd,
    bilstm_grid_bwd_reference,
    bilstm_grid_fwd,
    bilstm_grid_fwd_reference,
    fused_bilstm_grid,
    fused_lstm_recurrence,
    lstm_recurrence,
    lstm_recurrence_bwd,
    lstm_recurrence_bwd_reference,
    lstm_recurrence_reference,
)
