"""Model FLOPs of the seq2seq model, per sentence: a frozen copy.

The arithmetic of ``ecog2txt_tpu_torch/utils/flops.py`` as it stood when
the benchmark was defined, over a configuration file's ``model`` section
instead of the program's config object, so that a later change to the
program cannot move the yardstick.  Matmul FLOPs only (2·M·N·K per
product); the backward pass counts twice the forward, so a training step
is three forward passes; the conformer's attention counts the band only.
"""

from __future__ import annotations

from ..reference.seq2seq import conv_strides

# dense bf16 tensor-core peak of one NVIDIA H100 SXM (data sheet, 700 W)
H100_BF16_PEAK_FLOPS = 989e12


def conformer_forward_flops_per_step(conf: dict, in_dim: int, t: int | None = None) -> float:
    """Matmul FLOPs per encoder step of one forward pass through the
    conformer stack, the input projection included."""
    D, F = int(conf["model_dim"]), int(conf["ffn_dim"])
    kv_span = (int(conf["left_context"]) + 1) * int(conf["chunk_size"])
    if t is not None:
        kv_span = min(kv_span, t)
    ffn = 2.0 * D * F + 2.0 * F * D
    per_block = (
        ffn  # ffn1
        + ffn  # ffn2
        + 2.0 * D * (3 * D)  # qkv
        + 2.0 * D * D  # wo
        + 2 * (2.0 * kv_span * D)  # q·kᵀ and attention·v
        + 2.0 * D * (2 * D)  # conv pw1 (GLU: D → 2D)
        + 2.0 * D * D  # conv pw2
    )
    return 2.0 * in_dim * D + int(conf["num_blocks"]) * per_block


def seq2seq_forward_flops(model: dict, T: int, dec_len: int | None = None) -> float:
    """Matmul FLOPs of one forward pass for one sentence of ``T`` raw
    samples and ``dec_len`` decoder steps (default ``max_dec_len``)."""
    flops, t, in_dim = 0.0, T, int(model["in_channels"])
    for size, stride in zip(model["conv_sizes"], conv_strides(model)):
        t //= stride
        flops += 2.0 * t * (stride * in_dim) * size
        in_dim = size
    if model["encoder_type"] == "conformer":
        conf = model["conformer"]
        flops += t * conformer_forward_flops_per_step(conf, in_dim, t)
        enc_out = int(conf["model_dim"])
    else:
        for size in model["rnn_sizes"]:
            flops += 2 * (2.0 * t * in_dim * 4 * size + 2.0 * t * size * 4 * size)
            in_dim = 2 * size
        enc_out = in_dim
    heads = model["aux_heads"]
    if heads:
        dim = enc_out
        for size in model["aux_proj_sizes"]:
            flops += len(heads) * 2.0 * t * dim * size
            dim = size
        for head in heads:
            flops += 2.0 * t * dim * int(head["out_dim"])
    L = int(model["max_dec_len"]) if dec_len is None else dec_len
    dim = int(model["dec_embedding_size"])
    for size in model["dec_rnn_sizes"]:
        flops += 2.0 * L * dim * 4 * size + 2.0 * L * size * 4 * size
        dim = size
    return flops + 2.0 * L * dim * int(model["vocab_size"])


def train_step_flops(model: dict, T: int, dec_len: int | None = None) -> float:
    """Forward and backward: three forward passes, per sentence."""
    return 3.0 * seq2seq_forward_flops(model, T, dec_len)
