"""Plain PyTorch reference of the seq2seq model that the benchmark's cells run.

It computes the model of Makin et al. 2020 (a per-subject strided conv, a
biLSTM stack or a chunked-causal conformer, an auxiliary categorical head,
an LSTM decoder) and its training step (loss, gradients, global-norm clip,
Adam, EMA) with nothing but ``torch`` operations, from the configuration
file's ``model`` and ``training`` sections and a parameter tree of the
layout the benchmark makes (``harness/weights.py``).  It imports nothing
of the program under test and takes nothing it made: the benchmark hands
both sides the same weights, inputs and dropout generator seeds, and the
reference draws the dropout masks again, in the program's order.

Every product goes through ``precision``: ``exact`` (float32 operands,
TF32 off under :func:`no_tf32`) for the reference, ``fp8`` (each operand
rounded to float8 e4m3 with a per-tensor scale) for the control that must
come out as not correct.  The training step and the decoder run in blocks
of rows, so that the timed batch fits beside whatever else the process
holds.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_E4M3_MAX = 448.0
LN_EPS = 1e-6  # the conformer's LayerNorm


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------


def exact(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude maps to 448)."""
    x = x.detach().float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product in float8: rounded forward, the gradient
    passed through to the unrounded value."""
    x = x.float()
    return x + (_fp8_round(x) - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product in bfloat16 (the precision the
    configurations state: a witness for a reading, not a control)."""
    x = x.float()
    return x + (x.detach().to(torch.bfloat16).float() - x).detach()


class _RoundGradient(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded by ``rounding``, so
    that the backward products of a lower precision take its operands too."""

    @staticmethod
    def forward(ctx, y, rounding):
        ctx.rounding = rounding
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.rounding(g), None


PRECISIONS = {"float32": exact, "fp8": fp8, "bfloat16": bf16}
_GRADIENT_ROUNDING = {fp8: _fp8_round, bf16: lambda g: g.to(torch.bfloat16).float()}


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _mm(q, a, b):
    return _product(q, torch.matmul(q(a), q(b)))


def _product(q, y):
    """A product's result: in a lower precision its incoming gradient is
    rounded to it too."""
    if not y.requires_grad or q is exact:
        return y
    return _RoundGradient.apply(y, _GRADIENT_ROUNDING[q])


def _dense(q, p, x):
    return _mm(q, x, p["w"]) + p["b"]


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The slash-joined path of every leaf, in :func:`leaves`' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def leaves(tree) -> list:
    """Leaves of a tree of dicts and lists, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# --------------------------------------------------------------------------
# shapes and dropout
# --------------------------------------------------------------------------


def conv_strides(model: dict) -> list[int]:
    """One stride per conv layer, near-equal factors of the decimation."""
    remaining, n = int(model["decimation_factor"]), len(model["conv_sizes"])
    strides = []
    for i in range(n, 0, -1):
        s = max(int(round(remaining ** (1.0 / i))), 1)
        while remaining % s and s > 1:
            s -= 1
        strides.append(s)
        remaining //= s
    strides[-1] *= remaining
    return strides


def encoder_steps(model: dict, samples: int) -> int:
    t = samples
    for s in conv_strides(model):
        t //= s
    return t


def mask_shapes(model: dict, B: int, T: int, L: int) -> list[tuple[str, tuple]]:
    """The dropout masks of one training forward pass, in the order the
    program draws them: after each conv layer (time-major), the two
    directions' recurrent masks of each biLSTM layer and the mask between
    layers, then the decoder's recurrent masks and the masks between its
    layers.  ``T`` raw samples, ``L`` decoder steps."""
    out: list[tuple[str, tuple]] = []
    ff, rnn = float(model["FF_dropout"]) > 0, float(model["RNN_dropout"]) > 0
    t = T
    for size, stride in zip(model["conv_sizes"], conv_strides(model)):
        t //= stride
        if ff:
            out.append(("ff", (t, B, size)))
    if model["encoder_type"] != "conformer":
        sizes = model["rnn_sizes"]
        for i, size in enumerate(sizes):
            if rnn:
                out += [("rec", (B, size)), ("rec", (B, size))]
            if i < len(sizes) - 1 and ff:
                out.append(("ff", (t, B, 2 * size)))
    sizes = model["dec_rnn_sizes"]
    for i, size in enumerate(sizes):
        if rnn:
            out.append(("rec", (B, size)))
        if i < len(sizes) - 1 and ff:
            out.append(("ff", (L, B, size)))
    return out


def draw_masks(model: dict, generator: torch.Generator, B: int, T: int, L: int,
               device) -> list[tuple[str, torch.Tensor]]:
    """The masks of :func:`mask_shapes` drawn from ``generator``: a keep
    flag for feed-forward dropout, ``keep / (1 - rate)`` scales for the
    recurrent masks, as the program draws and applies them."""
    masks = []
    for kind, shape in mask_shapes(model, B, T, L):
        u = torch.rand(shape, generator=generator, device=device)
        if kind == "ff":
            masks.append((kind, u < 1.0 - float(model["FF_dropout"])))
        else:
            keep = 1.0 - float(model["RNN_dropout"])
            masks.append((kind, (u < keep).float() / keep))
    return masks


def _rows(masks, b0: int, b1: int):
    """The masks of batch rows ``[b0, b1)``: the batch axis is 1 of a
    time-major feed-forward mask and 0 of a recurrent one."""
    return [(k, m[:, b0:b1] if k == "ff" else m[b0:b1]) for k, m in masks]


class _Masks:
    def __init__(self, masks, model):
        self._it = iter(masks or [])
        self.train = masks is not None
        self.ff_keep = 1.0 - float(model["FF_dropout"])
        self.rnn = float(model["RNN_dropout"]) > 0

    def ff(self, x):
        if not self.train or self.ff_keep >= 1.0:
            return x
        kind, keep = next(self._it)
        assert kind == "ff" and keep.shape == x.shape, (kind, keep.shape, x.shape)
        return torch.where(keep, x / self.ff_keep, 0.0)

    def rec(self):
        if not (self.train and self.rnn):
            return None
        kind, m = next(self._it)
        assert kind == "rec", kind
        return m


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------


def reverse_valid(x: torch.Tensor, lengths: torch.Tensor, dim: int) -> torch.Tensor:
    """Each row's valid prefix reversed along ``dim`` (batch on the other
    leading axis), the padding left in place."""
    T = x.shape[dim]
    t = torch.arange(T, device=x.device)
    lens = lengths.to(x.device).long()
    src = torch.where(t[None, :] < lens[:, None], lens[:, None] - 1 - t[None, :], t[None, :])
    if dim == 0:  # (T, B, ...)
        src = src.T
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, dim, idx)


def conv_stack(q, params, model, x, lengths, subject, masks: _Masks, reverse: bool):
    """(B, T, C) raw samples → (T', B, F): each conv layer of width ==
    stride as a product over stride groups, ReLU, dropout; the LSTM
    family reads its input reversed."""
    xs = x.float()
    if reverse:
        xs = reverse_valid(xs, lengths, 1)
    for layer, stride in zip(params["subnet"]["conv"], conv_strides(model)):
        B, T, C = xs.shape
        t = T // stride
        w, b = layer["w"][subject], layer["b"][subject]
        h = torch.relu(_mm(q, xs[:, : t * stride].reshape(B, t, stride * C), w) + b)
        xs = masks.ff(h.transpose(0, 1)).transpose(0, 1)
    return xs.transpose(0, 1)


def lstm(q, p, xs, lengths, mask, reverse_time=False, state=None):
    """One LSTM direction over time-major ``xs``: gates (i, g, f, o), +1
    on the forget gate, the recurrent mask on ``h`` inside the product,
    the carry frozen and the output 0 past each row's length; reverse time
    runs t = T-1 down to 0 from a zero state."""
    T, B, _ = xs.shape
    H = p["wh"].shape[0]
    xw = _mm(q, xs, p["wx"]) + p["b"]
    if state is None:
        h = torch.zeros((B, H), device=xs.device)
        c = torch.zeros((B, H), device=xs.device)
    else:
        h, c = state
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse_time else range(T)):
        h_in = h if mask is None else h * mask
        i, g, f, o = (xw[t] + _mm(q, h_in, p["wh"])).chunk(4, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if lengths is not None:
            valid = (t < lengths)[:, None]
            h_new, c_new = torch.where(valid, h_new, h), torch.where(valid, c_new, c)
            out[t] = torch.where(valid, h_new, 0.0)
        else:
            out[t] = h_new
        h, c = h_new, c_new
    return torch.stack(out), (h, c)


def _layer_norm(p, x):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p["g"] + p["b"]


def _rotary(x, positions):
    half = x.shape[-1] // 2
    freq = 1.0 / (10000.0 ** (torch.arange(half, device=x.device).float() / half))
    angles = positions.float()[:, None] * freq
    cos, sin = torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, p, x, conf, lengths):
    """Chunk-causal multi-head self-attention with rotary q and k: a query
    sees the keys of its chunk and ``left_context`` chunks before it that
    lie inside its row's length."""
    B, T, D = x.shape
    H = int(conf["num_heads"])
    Dh = D // H
    qkv = _mm(q, _layer_norm(p["ln"], x), p["wqkv"]).reshape(B, T, 3, H, Dh)
    pos = torch.arange(T, device=x.device)
    qh, kh, vh = _rotary(qkv[:, :, 0], pos), _rotary(qkv[:, :, 1], pos), qkv[:, :, 2]
    scores = _product(q, torch.einsum("bthd,bshd->bhts", q(qh), q(kh))) / math.sqrt(Dh)
    C, L = int(conf["chunk_size"]), int(conf["left_context"])
    qc, kc = (pos // C)[:, None], (pos // C)[None, :]
    allowed = (kc <= qc) & (kc >= qc - L)
    allowed = allowed[None, None] & (pos[None, None, None, :] < lengths[:, None, None, None])
    # a large finite fill: a padded query with no key then averages every
    # key uniformly (its row is masked later) instead of giving NaN
    scores = torch.where(allowed, scores, -1e9)
    attn = torch.softmax(scores, dim=-1)
    out = _product(q, torch.einsum("bhts,bshd->bthd", q(attn), q(vh))).reshape(B, T, D)
    return _mm(q, out, p["wo"])


def _ffn(q, p, x):
    h = F.silu(_mm(q, _layer_norm(p["ln"], x), p["w1"]) + p["b1"])
    return _mm(q, h, p["w2"]) + p["b2"]


def _conv_module(q, p, x):
    """Pointwise D → 2D, GLU, depthwise causal conv (zeros before step
    0), SiLU, pointwise D → D."""
    B, T, D = x.shape
    h = F.glu(_mm(q, _layer_norm(p["ln"], x), p["pw1"]), dim=-1)
    K = p["dw"].shape[0]
    padded = torch.cat([torch.zeros((B, K - 1, D), device=x.device), h], dim=1)
    out = sum(padded[:, k : k + T] * p["dw"][k] for k in range(K))
    return _mm(q, F.silu(out), p["pw2"])


def conformer(q, params, conf, xs, lengths):
    """(B, T', F) → (B, T', D): the input projection, then each block
    ``x + ½FFN → x + MHSA → x + conv → x + ½FFN → LayerNorm``."""
    x = _mm(q, xs, params["in_proj"]["w"]) + params["in_proj"]["b"]
    for blk in params["blocks"]:
        x = x + 0.5 * _ffn(q, blk["ffn1"], x)
        x = x + _attention(q, blk["attn"], x, conf, lengths)
        x = x + _conv_module(q, blk["conv"], x)
        x = x + 0.5 * _ffn(q, blk["ffn2"], x)
        x = _layer_norm(blk["ln_out"], x)
    return x


def encode(q, params, model, x, lengths, subject, masks: _Masks):
    """Encoder outputs (T', B, E), the final state (h, c) the decoder starts
    from, and the encoder lengths."""
    conformer_family = model["encoder_type"] == "conformer"
    xs = conv_stack(q, params, model, x, lengths, subject, masks, reverse=not conformer_family)
    d = int(model["decimation_factor"])
    enc_lengths = torch.clamp((lengths.long() + d - 1) // d, max=xs.shape[0])
    if conformer_family:
        out = conformer(q, params["encoder"]["conformer"], model["conformer"],
                        xs.transpose(0, 1), enc_lengths)
        valid = (torch.arange(out.shape[1], device=out.device)[None, :]
                 < enc_lengths[:, None])[..., None]
        pooled = (out * valid).sum(dim=1) / torch.clamp(enc_lengths[:, None], min=1)
        return (out * valid).transpose(0, 1), (pooled, pooled), enc_lengths
    out, final = xs, None
    layers = params["encoder"]["rnn"]
    for i, layer in enumerate(layers):
        mf, mb = masks.rec(), masks.rec()
        of, (hf, cf) = lstm(q, layer["fwd"], out, enc_lengths, mf)
        ob, (hb, cb) = lstm(q, layer["bwd"], out, enc_lengths, mb, reverse_time=True)
        out = torch.cat([of, ob], dim=-1)
        final = (torch.cat([hf, hb], dim=-1), torch.cat([cf, cb], dim=-1))
        if i < len(layers) - 1:
            out = masks.ff(out)
    return out, final, enc_lengths


# --------------------------------------------------------------------------
# decoder and loss
# --------------------------------------------------------------------------


def _decoder_states(q, params, final):
    h, c = final
    dec = params["decoder"]
    if "bridge_h" in dec:
        h = torch.tanh(_dense(q, dec["bridge_h"], h))
        c = torch.tanh(_dense(q, dec["bridge_c"], c))
    states = [(h, c)]
    for layer in dec["rnn"][1:]:
        z = torch.zeros((h.shape[0], layer["wh"].shape[0]), device=h.device)
        states.append((z, z))
    return states


def teacher_forced_logits(q, params, model, final, tokens, masks: _Masks):
    """(L, B, V) logits of the decoder fed ``<pad>`` then ``tokens`` shifted
    right, started from the encoder's final state."""
    dec = params["decoder"]
    tokens = tokens.long()
    shifted = torch.cat([torch.full_like(tokens[:, :1], int(model["pad_id"])),
                         tokens[:, :-1]], dim=1)
    out = dec["embedding"][shifted].transpose(0, 1)
    states = _decoder_states(q, params, final)
    for i, layer in enumerate(dec["rnn"]):
        out, _ = lstm(q, layer, out, None, masks.rec(), state=states[i])
        if i < len(dec["rnn"]) - 1:
            out = masks.ff(out)
    return _dense(q, dec["out"], out)


def _nll(logits, targets):
    return -torch.gather(torch.log_softmax(logits, dim=-1), -1, targets.long()[..., None])[..., 0]


def loss_sums(q, params, model, batch, masks: _Masks):
    """Per head, the summed NLL over the valid steps or tokens of
    ``batch``; the training loss divides each by its count."""
    x, lengths = batch["encoder_inputs"], batch["encoder_lengths"]
    enc_out, final, enc_lengths = encode(q, params, model, x, lengths, batch["subject_idx"], masks)
    T = enc_out.shape[0]
    step_valid = torch.arange(T, device=x.device)[:, None] < enc_lengths[None, :]
    sums = {}
    conformer_family = model["encoder_type"] == "conformer"
    d = int(model["decimation_factor"])
    for head in model["aux_heads"]:
        p = params["aux"][head["name"]]
        h = enc_out
        for mlp in p["mlp"]:
            h = torch.relu(_dense(q, mlp, h))
        pred = _dense(q, p["out"], h)
        raw = batch[head["name"]].transpose(0, 1)
        if not conformer_family:
            raw = reverse_valid(raw, lengths, 0)
        aligned = raw[: T * d : d]
        sums[head["name"]] = (_nll(pred, aligned) * step_valid).sum()
    targets = batch["decoder_targets"]
    logits = teacher_forced_logits(q, params, model, final, targets, masks)
    L = targets.shape[1]
    tok_valid = torch.arange(L, device=x.device)[:, None] < batch["decoder_lengths"][None, :]
    sums["decoder_targets"] = (_nll(logits, targets.T) * tok_valid).sum()
    return sums


def loss_counts(model, batch) -> dict:
    """The divisors of :func:`loss_sums`: valid encoder steps per aux head,
    valid tokens for the decoder."""
    d = int(model["decimation_factor"])
    T = encoder_steps(model, batch["encoder_inputs"].shape[1])
    steps = torch.clamp((batch["encoder_lengths"].long() + d - 1) // d, max=T).sum()
    counts = {h["name"]: steps.float() for h in model["aux_heads"]}
    counts["decoder_targets"] = batch["decoder_lengths"].sum().float()
    return counts


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------


def _rows_of(batch: dict, b0: int, b1: int) -> dict:
    return {k: (v if k == "subject_idx" else v[b0:b1]) for k, v in batch.items()}


def loss_and_grads(q, params, model, training, batch, masks, rows_per_block):
    """The training loss of ``batch``, its gradients (one per leaf of
    ``params``, which require grad) and each head's mean loss, summed over
    blocks of rows."""
    counts = loss_counts(model, batch)
    scales = training.get("penalty_scales") or {}
    B = batch["encoder_inputs"].shape[0]
    flat = leaves(params)
    grads = [torch.zeros_like(p) for p in flat]
    parts = {k: 0.0 for k in counts}
    for b0 in range(0, B, rows_per_block or B):
        b1 = min(b0 + (rows_per_block or B), B)
        sums = loss_sums(q, params, model, _rows_of(batch, b0, b1),
                         _Masks(_rows(masks, b0, b1) if masks is not None else None, model))
        means = {k: s / torch.clamp(counts[k], min=1.0) for k, s in sums.items()}
        loss = sum(float(scales.get(k, 1.0)) * m for k, m in means.items())
        for g, d in zip(grads, torch.autograd.grad(loss, flat, allow_unused=True)):
            if d is not None:
                g += d
        for k, m in means.items():
            parts[k] += float(m.detach())
    total = sum(float(scales.get(k, 1.0)) * v for k, v in parts.items())
    return total, grads, parts


def train_steps(params0, model: dict, training: dict, steps, precision: str = "float32",
                rows_per_block: int | None = None) -> dict:
    """Follow the program's training steps from ``params0``: each step of
    ``steps`` is ``(batch, masks)``; loss, gradients, clip by the global
    norm, Adam (optax's defaults), EMA.  Returns each step's loss, the first
    step's clipped gradients, each head's loss at each step, and the
    parameters and the EMA after the last step (flat, in leaf order)."""
    q = PRECISIONS[precision]
    lr = float(training["learning_rate"])
    clip = float(training["clip_norm"])
    decay = float(training["ema_decay"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = tree_map(lambda t: t.detach().float().clone().requires_grad_(True), params0)
    flat = leaves(params)
    ema = [p.detach().clone() for p in flat]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    out = {"losses": [], "grads1": None, "parts": []}
    with no_tf32():
        for k, (batch, masks) in enumerate(steps, start=1):
            loss, grads, parts = loss_and_grads(q, params, model, training, batch, masks,
                                                rows_per_block)
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            scale = clip / torch.clamp(norm, min=clip)
            grads = [g * scale for g in grads]
            if k == 1:
                out["grads1"] = [g.clone() for g in grads]
            out["parts"].append(parts)
            with torch.no_grad():
                for p, g, mk, vk, e in zip(flat, grads, m, v, ema):
                    mk.mul_(b1).add_(g, alpha=1 - b1)
                    vk.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vk.sqrt() / math.sqrt(1 - b2 ** k)).add_(eps)
                    p.addcdiv_(mk, denom, value=-lr / (1 - b1 ** k))
                    e.mul_(decay).add_(p, alpha=1 - decay)
            out["losses"].append(float(loss))
    out["params"] = [p.detach() for p in flat]
    out["ema"] = ema
    return out


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------


def decode_logits(params, model, inputs, lengths, subject, tokens, precision="float32",
                  rows_per_block: int | None = None) -> torch.Tensor:
    """(B, L, V) logits of the decoder at each position of ``tokens``
    (B, L), fed the tokens before it: what greedy decoding saw when it
    chose them.  No dropout."""
    q = PRECISIONS[precision]
    B = inputs.shape[0]
    out = []
    with torch.no_grad(), no_tf32():
        for b0 in range(0, B, rows_per_block or B):
            b1 = min(b0 + (rows_per_block or B), B)
            masks = _Masks(None, model)
            _, final, _ = encode(q, params, model, inputs[b0:b1], lengths[b0:b1], subject, masks)
            logits = teacher_forced_logits(q, params, model, final, tokens[b0:b1], masks)
            out.append(logits.transpose(0, 1))
    return torch.cat(out)
