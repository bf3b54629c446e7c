"""Beam-search decoding.

The port of ``ecog2txt_tpu/models/beam.py``: a loop of ``max_dec_len``
batched decoder steps over a ``(B, K)`` beam tensor flattened into
``B·K`` rows, so all beams advance in one decoder step; ``torch.topk``
over the ``(B, K·V)`` candidates; beams re-gathered by backpointer each
step (the token prefixes are stored whole rather than backtracked:
decode lengths are ~20); finished beams frozen by a pad-only transition.

Length-normalised scoring: score = logprob / ((5+len)/6)^alpha (the GNMT
rule; alpha=0 ranks by raw log-probability).
"""

from __future__ import annotations

import torch

from ..ops.lstm import lstm_step
from .seq2seq import Seq2SeqConfig, _attend, _decoder_init_state, _dense, encode

NEG_INF = -1e9


def beam_decode(
    params,
    config: Seq2SeqConfig,
    inputs: torch.Tensor,  # (B, T, C)
    lengths: torch.Tensor,  # (B,)
    subject_idx,
    beam_width: int = 4,
    alpha: float = 0.6,
    return_all: bool = False,
    temperature: float = 0.0,
):
    """The best hypothesis ``(B, max_dec_len)`` int32, or with
    ``return_all`` ``(tokens (B, K, L), scores (B, K))`` sorted best-first.

    ``temperature`` > 0 divides the logits before scoring; 0 keeps the
    raw log-probabilities."""
    K = int(beam_width)
    enc_out, (h0, c0), enc_lengths = encode(params, config, inputs, lengths, subject_idx)
    decoder = params["decoder"]
    B = inputs.shape[0]
    V = config.vocab_size
    L = config.max_dec_len
    dev = enc_out.device

    def tile_beam(a):  # (B, H) → (B·K, H)
        return a.repeat_interleave(K, dim=0)

    states = [
        (tile_beam(h), tile_beam(c))
        for (h, c) in _decoder_init_state(params, config, (h0, c0))
    ]
    logprobs = torch.full((B, K), NEG_INF, device=dev)
    logprobs[:, 0] = 0.0  # only beam 0 is live at the start
    tokens = torch.full((B, K), config.pad_id, dtype=torch.long, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    hyps = torch.full((L, B, K), config.pad_id, dtype=torch.long, device=dev)
    # the transition of a finished beam: pad at no cost, anything else -inf
    pad_only = torch.full((V,), NEG_INF, device=dev)
    pad_only[config.pad_id] = 0.0

    for t in range(L):
        out = decoder["embedding"][tokens.reshape(B * K)]  # (B·K, E)
        new_states = []
        for layer, st in zip(decoder["rnn"], states):
            st_new, out = lstm_step(layer, st, out, None, config.compute_dtype)
            new_states.append(st_new)
        if config.use_attention:
            # (B·K, H) → (K, B, H) so _attend broadcasts over beams
            out_kbh = out.reshape(B, K, -1).transpose(0, 1)
            out_kbh = _attend(
                decoder["attn"], out_kbh, enc_out, enc_lengths, config.compute_dtype
            )
            out = out_kbh.transpose(0, 1).reshape(B * K, -1)
        logits = _dense(decoder["out"], out, config.compute_dtype)
        if temperature and temperature > 0:
            logits = logits / temperature
        step_logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        step_logp = torch.where(finished[..., None], pad_only, step_logp)

        cand = logprobs[..., None] + step_logp  # (B, K, V)
        logprobs, flat_idx = torch.topk(cand.reshape(B, K * V), K, dim=-1)
        beam_idx = torch.div(flat_idx, V, rounding_mode="floor")  # source beam
        token_idx = flat_idx % V

        def gather_beams(a):  # (B·K, H) along the chosen source beams
            aBK = a.reshape(B, K, -1)
            idx = beam_idx[..., None].expand(B, K, aBK.shape[-1])
            return torch.gather(aBK, 1, idx).reshape(B * K, -1)

        states = [(gather_beams(h), gather_beams(c)) for (h, c) in new_states]
        finished = torch.gather(finished, 1, beam_idx)
        emitted = torch.where(finished, config.pad_id, token_idx)
        finished = finished | (token_idx == config.eos_id)
        # re-gather the prefixes along the chosen beams, then append
        hyps = torch.gather(hyps, 2, beam_idx[None].expand(L, B, K))
        hyps[t] = emitted
        tokens = emitted

    # length-normalised scores; a hypothesis' length counts its non-pad tokens
    hyp_lengths = (hyps != config.pad_id).sum(dim=0).float()
    norm = ((5.0 + hyp_lengths) / 6.0) ** alpha
    scores = logprobs / torch.clamp(norm, min=1e-6)

    order = torch.argsort(-scores, dim=1, stable=True)  # (B, K) best-first
    hyps_bkl = hyps.permute(1, 2, 0)  # (B, K, L)
    hyps_sorted = torch.gather(hyps_bkl, 1, order[..., None].expand(B, K, L)).to(torch.int32)
    scores_sorted = torch.gather(scores, 1, order)
    if return_all:
        return hyps_sorted, scores_sorted
    return hyps_sorted[:, 0]
