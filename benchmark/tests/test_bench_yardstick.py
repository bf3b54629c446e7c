"""The frozen arithmetic (``benchmark/yardstick/``) reproduces the kernel
table's bounds and the program's FLOP counts at the main shapes."""

from __future__ import annotations

import pytest

from benchmark.harness import port, registry
from benchmark.yardstick import bounds, categories, flops

from ecog2txt_tpu_torch.utils import flops as program_flops


BASELINE_CONFORMER = {"num_blocks": 4, "model_dim": 384, "num_heads": 6, "ffn_dim": 1536,
                      "conv_kernel": 8}  # the repository's headline conformer (4 x 384)


def _model(name):
    if name == "conformer-4x384":
        model = registry.config(registry.benchmark(), "conformer-m")["model"]
        return {**model, "conformer": {**model["conformer"], **BASELINE_CONFORMER}}
    return registry.config(registry.benchmark(), name)["model"]


def test_bounds_reproduce_the_kernel_table():
    """``bound_ms`` of PERF.md's kernel table: K1f and K1b at B=256, T'=104,
    H=400; K2f, K2b-dq, K2b-dkv at B=256, D=384, 6 heads over the kernels'
    padded 128 rows and the band of 104 valid steps, bf16."""
    assert round(bounds.k1f_ms(256, 104, 400), 4) == 0.0345
    assert round(bounds.k1b_ms(256, 104, 400), 4) == 0.0773
    att = bounds.attention_ms(256, 128, 384, 6, bounds.band_pairs(104, 16, 1))
    assert [round(att[k], 4) for k in ("K2f", "K2b-dq", "K2b-dkv")] == [0.0303, 0.0380, 0.0455]


def test_band_pairs_counts_the_chunk_causal_band():
    # chunks of 4 with one chunk of look-back over 10 steps: 4·4 + 4·8 + 2·6
    assert bounds.band_pairs(10, 4, 1) == 16 + 32 + 12


@pytest.mark.parametrize("name, train_gf, decode_gf", [
    ("bilstm-makin2020", 6.584, 2.266), ("conformer-4x384", 9.285, 3.167),
    ("conformer-m", 15.945, 5.387)])
def test_flops_a_sentence(name, train_gf, decode_gf):
    model = _model(name)
    assert round(flops.train_step_flops(model, 1248, 12) / 1e9, 3) == train_gf
    assert round(flops.seq2seq_forward_flops(model, 1248) / 1e9, 3) == decode_gf


@pytest.mark.parametrize("name", ["bilstm-makin2020", "conformer-m"])
@pytest.mark.parametrize("dec_len", [12, 20])
def test_flops_equal_the_programs_count(name, dec_len):
    model = _model(name)
    assert flops.seq2seq_forward_flops(model, 1248, dec_len) == pytest.approx(
        program_flops.seq2seq_forward_flops(port.seq2seq_config(model), 1248, dec_len), rel=1e-12)


@pytest.mark.parametrize("kernel, category", [
    ("void lstm_recurrence_fwd_cluster_kernel<32>(...)", "K1f"),
    ("lstm_recurrence_bwd_cluster_kernel", "K1b"),
    ("banded_attention_fwd_tc_kernel", "K2f"), ("banded_attention_dq_tc_kernel", "K2b-dq"),
    ("banded_attention_dkv_tc_kernel", "K2b-dkv"), ("layer_norm_bwd_rows_kernel", "K5b"),
    ("nvjet_tst_128x64_64x8_1x1_v_bz_coopA_TNT", "GEMM"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8", "GEMM"),
    ("Memcpy DtoH (Device -> Pinned)", "memcpy"),
    ("at::native::vectorized_elementwise_kernel", "other kernels")])
def test_categories(kernel, category):
    assert categories.category(kernel) == category
