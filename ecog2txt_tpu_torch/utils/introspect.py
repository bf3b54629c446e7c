"""Checkpoint introspection: hyperparameters from tensor shapes.

The port's copy of ``ecog2txt_tpu/utils/introspect.py``.  The reference
stores no hyperparameter metadata: it rebuilds the architecture from its
checkpoint's variable names and shapes (``recover_model_sizes``,
reference trainers.py:444-554: LSTM kernels pack 4 matrices → size//4,
projections transposed, conv kernels give strides).  Given a parameter
tree of the port (``init_seq2seq``'s layout) or a ``ckpt-<epoch>.pt`` file
(``convert.save_checkpoint``), this recovers the ``layer_sizes`` block and
the model dimensions.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _shape_tree(params: Any) -> dict:
    """``{"subnet/conv/0/w": shape, ...}``: every leaf of a tree of dicts
    and lists by its slash-joined path."""
    out: dict[str, tuple] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            out["/".join(path)] = tuple(node.shape)

    walk(params, [])
    return out


def recover_model_sizes(source: Any, in_channels: int | None = None) -> dict:
    """Architecture description from a parameter tree or the path of a
    ``ckpt-<epoch>.pt`` checkpoint.

    Returns a dict mirroring the manifest ``layer_sizes`` block plus
    inferred dimensions: num_subjects, conv strides (needs
    ``in_channels``), encoder/decoder LSTM sizes (recovered from the
    4H gate kernels, like the reference's //4 rule), vocab size, aux head
    dims, and for the conformer family its blocks, widths, kernel and MoE
    width (heads, chunk and left context leave no trace in the shapes).
    """
    if isinstance(source, str):
        from ..convert import load_checkpoint

        params = load_checkpoint(source, device="cpu")["params"]
    else:
        params = source
    shapes = _shape_tree(params)

    out: dict[str, Any] = {"layer_sizes": {}}
    conv_sizes, conv_strides = [], []
    in_dim = in_channels
    i = 0
    while f"subnet/conv/{i}/w" in shapes:
        s, rows, size = shapes[f"subnet/conv/{i}/w"]
        out["num_subjects"] = s
        conv_sizes.append(size)
        if in_dim is not None:
            conv_strides.append(rows // in_dim)
        in_dim = size
        i += 1
    out["layer_sizes"]["encoder_embedding"] = conv_sizes
    if conv_strides:
        out["conv_strides"] = conv_strides
        out["decimation_factor"] = int(np.prod(conv_strides))

    rnn_sizes = []
    i = 0
    while f"encoder/rnn/{i}/fwd/wh" in shapes:
        # gate kernel (H, 4H): recover H
        rnn_sizes.append(shapes[f"encoder/rnn/{i}/fwd/wh"][0])
        i += 1
    out["layer_sizes"]["encoder_rnn"] = rnn_sizes
    out["BIDIRECTIONAL"] = "encoder/rnn/0/bwd/wh" in shapes
    if rnn_sizes:
        out["encoder_type"] = "lstm"

    if "encoder/conformer/in_proj/w" in shapes:
        out["encoder_type"] = "conformer"
        conf: dict[str, int] = {"model_dim": shapes["encoder/conformer/in_proj/w"][1]}
        nb = 0
        while f"encoder/conformer/blocks/{nb}/ln_out/g" in shapes:
            nb += 1
        conf["num_blocks"] = nb
        if nb:
            b0 = "encoder/conformer/blocks/0"
            conf["ffn_dim"] = shapes[f"{b0}/ffn1/w1"][1]
            conf["conv_kernel"] = shapes[f"{b0}/conv/dw"][0]
            # explicitly 0 for a dense tree, so that restoring a dense
            # checkpoint into an MoE-constructed trainer switches MoE off
            conf["moe_experts"] = (
                shapes[f"{b0}/ffn2/wg"][1] if f"{b0}/ffn2/wg" in shapes else 0
            )
        out["conformer"] = conf

    aux_sizes: list[int] = []
    for key, shape in sorted(shapes.items()):
        if key.startswith("aux/") and key.endswith("/mlp/0/w"):
            aux_sizes = [shape[1]]
        if key.startswith("aux/") and key.endswith("/out/w"):
            out.setdefault("aux_heads", {})[key.split("/")[1]] = shape[1]
    out["layer_sizes"]["encoder_1_projection"] = aux_sizes

    if "decoder/embedding" in shapes:
        vocab, emb = shapes["decoder/embedding"]
        out["vocab_size"] = vocab
        out["layer_sizes"]["decoder_embedding"] = [emb]
    dec_sizes = []
    i = 0
    while f"decoder/rnn/{i}/wh" in shapes:
        dec_sizes.append(shapes[f"decoder/rnn/{i}/wh"][0])
        i += 1
    out["layer_sizes"]["decoder_rnn"] = dec_sizes
    if "decoder/out/w" in shapes:
        out["layer_sizes"]["decoder_projection"] = []
        out.setdefault("vocab_size", shapes["decoder/out/w"][1])
    out["use_attention"] = "decoder/attn/wa/w" in shapes
    return out
