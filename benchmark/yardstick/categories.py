"""Kernel names to the program's kernels and categories: a frozen copy of
``chip_smoke.py``'s ``_KERNEL_CATEGORIES`` and ``_category``."""

from __future__ import annotations

KERNEL_CATEGORIES = (
    ("lstm_recurrence_fwd", "K1f"), ("lstm_recurrence_bwd", "K1b"),
    ("banded_attention_fwd_kernel", "K2f"), ("banded_attention_fwd_tc_kernel", "K2f"),
    ("banded_attention_dq_kernel", "K2b-dq"), ("banded_attention_dq_tc_kernel", "K2b-dq"),
    ("banded_attention_dkv_kernel", "K2b-dkv"), ("banded_attention_dkv_tc_kernel", "K2b-dkv"),
    ("fused_attention_fwd_kernel", "K3f"), ("fused_attention_fwd_tc_kernel", "K3f"),
    ("fused_attention_prep_kernel", "K3f"),
    ("bilstm_grid_fwd_kernel", "K4f"), ("bilstm_grid_fwd_cluster_kernel", "K4f"),
    ("bilstm_grid_bwd_kernel", "K4b"),
    ("bilstm_grid_bwd_cluster_kernel", "K4b"),
    ("layer_norm_fwd_kernel", "K5f"), ("layer_norm_bwd_kernel", "K5b"),
    ("layer_norm_bwd_rows_kernel", "K5b"), ("layer_norm_bwd_sum_kernel", "K5b"),
)


def category(kernel: str) -> str:
    for key, cat in KERNEL_CATEGORIES:
        if key in kernel:
            return cat
    if "Memcpy" in kernel or "Memset" in kernel:
        return "memcpy"
    if any(k in kernel.lower() for k in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "GEMM"
    return "other kernels"
