"""Seeded weights in the layout of the port's ``init_seq2seq``.

The same keys, shapes and initialisers (Glorot-uniform products, block-
orthogonal LSTM recurrences, scaled normal embeddings and depthwise
kernels, zero biases, unit LayerNorm gains), made on the device from one
``torch.Generator`` in a few large calls: one uniform draw for every
uniform leaf, one normal draw for every normal leaf, one batched QR per
recurrent width.  float32, the type the trainer keeps its weights in.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..reference.seq2seq import conv_strides


class Spec(NamedTuple):
    shape: tuple
    kind: str  # 'uniform' | 'normal' | 'orthogonal4' | 'zeros' | 'ones'
    scale: float = 1.0


def _glorot(fan_in: int, fan_out: int, lead: tuple = ()) -> Spec:
    return Spec(lead + (fan_in, fan_out), "uniform", math.sqrt(6.0 / (fan_in + fan_out)))


def _dense(fan_in: int, fan_out: int) -> dict:
    return {"w": _glorot(fan_in, fan_out), "b": Spec((fan_out,), "zeros")}


def _lstm(fan_in: int, H: int) -> dict:
    return {"wx": _glorot(fan_in, 4 * H), "wh": Spec((H, 4 * H), "orthogonal4"),
            "b": Spec((4 * H,), "zeros")}


def _ln(D: int) -> dict:
    return {"g": Spec((D,), "ones"), "b": Spec((D,), "zeros")}


def _conformer(conf: dict, in_dim: int) -> dict:
    D, Fd, K = int(conf["model_dim"]), int(conf["ffn_dim"]), int(conf["conv_kernel"])

    def ffn():
        return {"w1": _glorot(D, Fd), "b1": Spec((Fd,), "zeros"), "w2": _glorot(Fd, D),
                "b2": Spec((D,), "zeros"), "ln": _ln(D)}

    return {
        "in_proj": {"w": _glorot(in_dim, D), "b": Spec((D,), "zeros")},
        "blocks": [{
            "ffn1": ffn(),
            "attn": {"wqkv": _glorot(D, 3 * D), "wo": _glorot(D, D), "ln": _ln(D)},
            "conv": {"pw1": _glorot(D, 2 * D), "dw": Spec((K, D), "normal", 0.1),
                     "pw2": _glorot(D, D), "ln": _ln(D)},
            "ffn2": ffn(),
            "ln_out": _ln(D),
        } for _ in range(int(conf["num_blocks"]))],
    }


def layout(model: dict) -> dict:
    """The parameter tree of ``model`` (a configuration's ``model``
    section) with a :class:`Spec` at each leaf."""
    S = int(model["num_subjects"])
    conv, dim = [], int(model["in_channels"])
    for size, stride in zip(model["conv_sizes"], conv_strides(model)):
        conv.append({"w": _glorot(dim * stride, size, (S,)), "b": Spec((S, size), "zeros")})
        dim = size
    if model["encoder_type"] == "conformer":
        encoder = {"conformer": _conformer(model["conformer"], dim)}
        enc_out = int(model["conformer"]["model_dim"])
    else:
        rnn = []
        for H in model["rnn_sizes"]:
            rnn.append({"fwd": _lstm(dim, H), "bwd": _lstm(dim, H)})
            dim = 2 * H
        encoder, enc_out = {"rnn": rnn}, dim
    aux = {}
    for head in model["aux_heads"]:
        mlp, d = [], enc_out
        for size in model["aux_proj_sizes"]:
            mlp.append(_dense(d, size))
            d = size
        aux[head["name"]] = {"mlp": mlp, "out": _dense(d, int(head["out_dim"]))}
    V, E = int(model["vocab_size"]), int(model["dec_embedding_size"])
    decoder: dict = {"embedding": Spec((V, E), "normal", 1.0 / math.sqrt(E))}
    rnn, d = [], E
    for H in model["dec_rnn_sizes"]:
        rnn.append(_lstm(d, H))
        d = H
    decoder["rnn"] = rnn
    if enc_out != model["dec_rnn_sizes"][0]:
        decoder["bridge_h"] = _dense(enc_out, model["dec_rnn_sizes"][0])
        decoder["bridge_c"] = _dense(enc_out, model["dec_rnn_sizes"][0])
    decoder["out"] = _dense(d, V)
    return {"subnet": {"conv": conv}, "encoder": encoder, "aux": aux, "decoder": decoder}


def _specs(tree) -> list[Spec]:
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _specs(v)]
    return [s for v in tree for s in _specs(v)]


def _fill(tree, items):
    if isinstance(tree, Spec):
        return next(items)
    if isinstance(tree, dict):
        return {k: _fill(v, items) for k, v in tree.items()}
    return [_fill(v, items) for v in tree]


def make_weights(model: dict, seed: int, device) -> dict:
    """The parameter tree of ``model`` drawn from ``seed`` on ``device``."""
    specs = layout(model)
    flat = _specs(specs)
    g = torch.Generator(device=device).manual_seed(seed)
    numel = lambda s: math.prod(s.shape)  # noqa: E731
    uniform = torch.rand(sum(numel(s) for s in flat if s.kind == "uniform"),
                         generator=g, device=device) * 2 - 1
    normal = torch.randn(sum(numel(s) for s in flat if s.kind == "normal"),
                         generator=g, device=device)
    ortho: dict[int, torch.Tensor] = {}
    for H in sorted({s.shape[0] for s in flat if s.kind == "orthogonal4"}):
        n = 4 * sum(1 for s in flat if s.kind == "orthogonal4" and s.shape[0] == H)
        a = torch.randn((n, H, H), generator=g, device=device)
        qm, r = torch.linalg.qr(a)
        ortho[H] = qm * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    out, offsets = [], {"uniform": 0, "normal": 0}
    used = {H: 0 for H in ortho}
    for s in flat:
        if s.kind in offsets:
            src = uniform if s.kind == "uniform" else normal
            o = offsets[s.kind]
            out.append((src[o : o + numel(s)].reshape(s.shape) * s.scale).clone())
            offsets[s.kind] = o + numel(s)
        elif s.kind == "orthogonal4":
            H, i = s.shape[0], used[s.shape[0]]
            out.append(torch.cat(list(ortho[H][i : i + 4]), dim=1).contiguous())
            used[H] = i + 4
        else:
            out.append((torch.zeros if s.kind == "zeros" else torch.ones)(s.shape, device=device))
    return _fill(specs, iter(out))
