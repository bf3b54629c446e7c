"""The host-side planners that choose, before a launch, which body of a
kernel runs and how its grid is cut: K1b's cluster body (cluster size,
rows per cluster), K2f's tensor-core body and K3f's query block.  They
take the card's SM count and shared-memory limit as arguments, so they
run here without a card; the H100's figures are 132 SMs and 227 KB
(232448 bytes) of opt-in shared memory a block.
"""

import pytest
import torch

from ecog2txt_tpu_torch.ops import attention_kernels as ak
from ecog2txt_tpu_torch.ops import lstm_kernels as lk

SMS, SMEM = 132, 232448


@pytest.mark.parametrize(
    "B, H, cs, clusters",
    [(256, 400, 8, 16), (16, 400, 8, 1), (1, 400, 8, 1), (17, 100, 2, 2), (16, 64, 1, 1)],
)
def test_bf16_adjoint_runs_the_cluster_body(B, H, cs, clusters):
    """bf16 at the model's widths: the fewest CTAs a cluster whose weight
    slice fits (8 at H=400: 16 clusters of 8 CTAs at B=256; 1 at the
    demo's H=64), 16 rows a cluster, ragged B padded."""
    plan = lk.plan_bwd_body(torch.bfloat16, B, H, SMS, SMEM)
    assert plan == {"body": "cluster", "cluster_size": cs, "rows_per_cluster": 16,
                    "clusters": clusters, "smem": lk._cluster_smem(H, cs)}
    assert plan["smem"] <= SMEM


def test_cluster_slice_budget_at_the_headline_width():
    """H=400, 8 CTAs of 52 units (a multiple of 4; the last CTA owns 36):
    the partials pushed to a CTA (8 x 16 x 52 f32), the resident slice
    (400 x 216 bf16), the step's rows, the dgates slice and the pairs'
    step inputs (16 x 7 x 52) take 231040 of 232448 bytes."""
    assert lk._cluster_units(400, 8) == 52 and lk._cluster_units(100, 2) == 52
    assert lk._cluster_smem(400, 8) == (8 * 16 * 52 * 4 + 400 * 216 * 2 + 16 * 408 * 2
                                        + 16 * 216 * 2 + 16 * 7 * 52 * 2) == 231040
    assert lk._cluster_smem(64, 1) == (16 * 64 * 4 + 64 * 264 * 2 + 16 * 72 * 2
                                       + 16 * 264 * 2 + 16 * 7 * 64 * 2)


@pytest.mark.parametrize(
    "dtype, B, H, rows",
    [(torch.float32, 256, 400, 2), (torch.float32, 16, 64, 1),
     (torch.bfloat16, 256, 512, 2), (torch.bfloat16, 16, 1024, 1)],
)
def test_f32_and_wide_adjoints_keep_the_rows_body(dtype, B, H, rows):
    """f32 (no f32 tensor-core product) and widths whose slice fits no
    cluster of at most 8 CTAs keep the rows body, with its rows per block."""
    assert lk.plan_bwd_body(dtype, B, H, SMS, SMEM) == {"body": "rows", "rows_per_block": rows}


def test_cluster_body_needs_the_shared_memory():
    """Less shared memory a block pushes the plan to more CTAs a cluster,
    then to the rows body."""
    assert lk.plan_bwd_body(torch.bfloat16, 16, 100, SMS, 48 * 1024)["cluster_size"] == 4
    assert lk.plan_bwd_body(torch.bfloat16, 16, 400, SMS, 100 * 1024)["body"] == "rows"


@pytest.mark.parametrize(
    "dtype, QB, W, Dh, body",
    [(torch.bfloat16, 128, 144, 64, "tensor_core"),  # headline, request, long
     (torch.bfloat16, 128, 132, 16, "tensor_core"),  # the demo trainer
     (torch.bfloat16, 32, 48, 48, "tensor_core"),
     (torch.bfloat16, 40, 48, 96, "tensor_core"),
     (torch.bfloat16, 128, 144, 256, "tensor_core"),
     (torch.bfloat16, 128, 144, 384, "cuda_core"),  # does not fit
     (torch.float32, 128, 144, 64, "cuda_core")],
)
def test_k2f_body_by_dtype_and_shape(dtype, QB, W, Dh, body):
    assert ak.plan_k2f_body(dtype, QB, W, Dh, SMEM) == body


def test_k2f_tensor_core_block_is_smaller_than_the_f32_staging():
    """At the headline shape the bf16 block stages ~60 KB (Q, K, V padded
    to 72-element rows, the keys' chunk ids, the window's average) where
    the CUDA-core body staged 75 KB of f32 K/V alone."""
    assert ak._k2f_tc_smem(128, 144, 64) == 2 * (128 + 2 * 144) * 72 + 4 * 144 + 4 * 64 + 16
    assert ak._k2f_tc_smem(128, 144, 64) == 60752 < 2 * 144 * 65 * 4
    assert ak._k2f_tc_smem(40, 48, 20) == 2 * (48 + 2 * 48) * 40 + 4 * 48 + 4 * 32 + 16


@pytest.mark.parametrize(
    "Dh, rows", [(64, 128), (96, 128), (128, 96), (288, 32), (384, 16)],
)
def test_k3f_query_block_fits_shared_memory(Dh, rows):
    """The largest multiple of L·C (16) up to 128 rows whose K3f block fits
    227 KB; head dims above 256 take 2 columns a thread and fit at 32 (288)
    and 16 (384) rows."""
    QB = ak.plan_fused_query_rows(128, 16, 1, Dh, SMEM)
    assert QB == rows and QB % 16 == 0
    assert ak._fused_smem(QB, QB + 16, Dh) <= SMEM
    if QB < 128:
        assert ak._fused_smem(QB + 16, QB + 32, Dh) > SMEM


def test_k3f_query_block_refuses_what_no_block_fits():
    with pytest.raises(ValueError, match="head dim 640"):
        ak.plan_fused_query_rows(128, 16, 1, 640, SMEM)
    with pytest.raises(ValueError, match="no query block fits"):
        ak.plan_fused_query_rows(128, 16, 1, 384, 150 * 1024)


def test_cuda_core_attention_blocks_against_shared_memory():
    """The CUDA-core K2f/K2b blocks stage the window in f32: they fit at
    the conformer's head dim 64 and at 128, and not at 256, where the card
    refuses them (bf16 K2f runs the tensor-core body there)."""
    assert ak._cuda_core_smem("K2f", 144, 64) == 4 * (2 * 144 * 65 + 8 * (64 + 144))
    assert ak._cuda_core_smem("K2b-dkv", 144, 64) == 4 * (2 * 144 * 65 + 2 * 144
                                                          + 8 * (2 * 64 + 2 * 144))
    for kernel in ("K2f", "K2b-dq", "K2b-dkv"):
        assert ak._cuda_core_smem(kernel, 144, 128) <= SMEM
        assert ak._cuda_core_smem(kernel, 144, 256) > SMEM
