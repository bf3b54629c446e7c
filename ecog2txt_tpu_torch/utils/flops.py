"""Model-FLOP accounting for MFU reporting.

The port's copy of ``ecog2txt_tpu/utils/flops.py`` (framework-free): the
matmul FLOPs (2·M·N·K per GEMM) of one forward pass through the seq2seq
model as configured, per sentence.  MFU = achieved model FLOP/s ÷ the
card's peak; the peak here is the NVIDIA H100 SXM's dense bf16
tensor-core rate from its data sheet.

Convention (standard in the scaling literature): the backward pass counts
2× the forward matmul FLOPs, so a training step is 3× forward.
Elementwise work (gate nonlinearities, masking, the optimizer update) is
left out.
"""

from __future__ import annotations

# dense bf16 tensor-core peak of one NVIDIA H100 SXM (data sheet: 989.4
# TFLOP/s without sparsity)
H100_BF16_PEAK_FLOPS = 989e12


def conformer_encoder_forward_flops_per_step(
    ccfg, in_dim: int, t: int | None = None
) -> float:
    """Matmul FLOPs per encoder step (token) of one FORWARD pass through
    the conformer stack incl. the input projection (the conv module's GLU
    projection is D→2D).  Attention is counted band-only, the model
    convention: the dense short-T path computes slightly more."""
    D, F = ccfg.model_dim, ccfg.ffn_dim
    kv_span = (ccfg.left_context + 1) * ccfg.chunk_size
    if t is not None:
        kv_span = min(kv_span, t)
    if getattr(ccfg, "moe_experts", 0):
        # MoE ffn2: router GEMM + top-k routed expert FFNs per token —
        # the MODEL-FLOPs convention counts the routed work (k experts
        # per token); the exact no-drop execution path
        # (moe_capacity_factor=0) physically runs all E experts, so its
        # executed FLOPs exceed this count — same band-only spirit as
        # the attention convention above
        ffn2 = 2.0 * D * ccfg.moe_experts + ccfg.moe_topk * (
            2.0 * D * F + 2.0 * F * D
        )
    else:
        ffn2 = 2.0 * D * F + 2.0 * F * D
    per_block = (
        (2.0 * D * F + 2.0 * F * D)  # ffn1 (two GEMMs)
        + ffn2
        + 2.0 * D * (3 * D)  # qkv
        + 2.0 * D * D  # wo
        + 2 * (2.0 * kv_span * D)  # qk^T and attn·v
        + 2.0 * D * (2 * D)  # conv pw1 (GLU: D → 2D)
        + 2.0 * D * D  # conv pw2
    )
    return 2.0 * in_dim * D + ccfg.num_blocks * per_block


def seq2seq_forward_flops(
    config, T: int, dec_len: int | None = None
) -> float:
    """Matmul FLOPs of one forward pass for ONE sentence of ``T`` raw
    samples (``config``: models.seq2seq.Seq2SeqConfig)."""
    flops = 0.0
    # subnet conv stack: (T', d·C) @ (d·C, size) per layer
    t = T
    in_dim = config.in_channels
    for size, stride in zip(config.conv_sizes, config.conv_strides):
        t = t // stride
        flops += 2.0 * t * (stride * in_dim) * size
        in_dim = size
    if not config.conv_sizes:
        t = T // config.decimation_factor

    if config.encoder_type == "conformer":
        ccfg = config.conformer
        flops += t * conformer_encoder_forward_flops_per_step(
            ccfg, in_dim, t
        )
        enc_out_dim = ccfg.model_dim
        in_dim = ccfg.model_dim
    else:
        directions = 2 if config.BIDIRECTIONAL else 1
        for size in config.rnn_sizes:
            # hoisted input GEMM + serial recurrent GEMM, per direction
            flops += directions * (
                2.0 * t * in_dim * 4 * size + 2.0 * t * size * 4 * size
            )
            in_dim = directions * size
        enc_out_dim = in_dim

    # aux heads: shared MLP trunk + per-head output projection
    if config.aux_heads:
        dim = enc_out_dim
        for size in config.aux_proj_sizes:
            flops += len(config.aux_heads) * 2.0 * t * dim * size
            dim = size
        for head in config.aux_heads:
            flops += 2.0 * t * dim * head.out_dim

    # decoder: embedding lookup is a gather (no matmul); LSTM stack +
    # vocab projection per emitted token
    L = dec_len if dec_len is not None else config.max_dec_len
    dim = config.dec_embedding_size
    for size in config.dec_rnn_sizes:
        flops += 2.0 * L * dim * 4 * size + 2.0 * L * size * 4 * size
        dim = size
    if config.use_attention:
        flops += (
            2.0 * L * dim * enc_out_dim  # wa
            + 2 * (2.0 * L * t * enc_out_dim)  # scores + context
            + 2.0 * L * (dim + enc_out_dim) * dim  # wc
        )
    flops += 2.0 * L * dim * config.vocab_size
    return flops


def train_step_flops(config, T: int, dec_len: int | None = None) -> float:
    """fwd + bwd ≈ 3× forward matmul FLOPs per sentence."""
    return 3.0 * seq2seq_forward_flops(config, T, dec_len)


def mfu(
    sentences_per_sec: float,
    flops_per_sentence: float,
    peak_flops: float = H100_BF16_PEAK_FLOPS,
) -> float:
    """Achieved model-FLOP utilization fraction."""
    return sentences_per_sec * flops_per_sentence / peak_flops
