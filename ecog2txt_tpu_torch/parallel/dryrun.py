"""One training step of every parallel mode on tiny shapes.

    python -m ecog2txt_tpu_torch.parallel.dryrun --world 4 [--device cpu]

The ranks run on the card (gloo ranks sharing it where the world holds
more ranks than cards) unless ``--device cpu`` is given; without a card
that is an error, as at every entry point of the port.

The port's counterpart of ``__graft_entry__.dryrun_multichip``: on each
rank of a world (started here with ``launch.spawn``, gloo ranks), every
mode whose mesh the world fills (the ``data`` axis takes the ranks the
other axes leave) takes one step of ``make_dp_train_step`` (clip 10, Adam,
EMA) on a tiny model: dp × tp (biLSTM), sp, dp × pp, ep, ep × pp, sp × pp,
tp × sp, tp × pp, and on 8 ranks ep × sp × pp and tp × sp × pp.  Each
step's global loss must equal the one-process loss of the same weights and
batch, which every rank also computes (f32 rtol 1e-4); the ranks' losses
are returned by mode.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..convert import tree_leaves, tree_map
from ..models.conformer import ConformerConfig
from ..models.seq2seq import AuxHead, Seq2SeqConfig, init_seq2seq, seq2seq_loss
from .mesh import Placement, make_dp_train_step, make_mesh

_SEQ = Seq2SeqConfig(
    vocab_size=12, in_channels=8, conv_sizes=(16,), decimation_factor=2, rnn_sizes=(24,),
    aux_proj_sizes=(16,), aux_heads=(AuxHead("encoder_1_targets", "categorical", 10),),
    dec_embedding_size=12, dec_rnn_sizes=(48,), max_dec_len=6, FF_dropout=0.0,
    RNN_dropout=0.0,
)
_CONFORMER = ConformerConfig(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64,
                             conv_kernel=4, chunk_size=4, left_context=1)
# groups of 8 steps divide the shards (16 steps) and the halo (16)
_MOE = dataclasses.replace(_CONFORMER, moe_experts=4, moe_topk=2, moe_capacity_factor=1.25,
                           moe_group_size=8)
# mode → (model, seq, pp, which weights the model axis splits, conformer)
MODES = {
    "dp_tp": (2, 1, 1, "tp", None),
    "sp": (1, 2, 1, None, _CONFORMER),
    "dp_pp": (1, 1, 2, None, _CONFORMER),
    "ep": (2, 1, 1, "ep", _MOE),
    "ep_pp": (2, 1, 2, "ep", _MOE),
    "sp_pp": (1, 2, 2, None, _CONFORMER),
    "tp_sp": (2, 2, 1, "tp", _CONFORMER),
    "tp_pp": (2, 1, 2, "tp", _CONFORMER),
    "ep_sp_pp": (2, 2, 2, "ep", _MOE),
    "tp_sp_pp": (2, 2, 2, "tp", _CONFORMER),
}


def _batch(B: int, T: int, device) -> dict:
    rng = np.random.default_rng(0)
    batch = {
        "encoder_inputs": rng.normal(size=(B, T, 8)).astype(np.float32),
        "encoder_lengths": rng.integers(T // 2, T + 1, size=B).astype(np.int32),
        "decoder_targets": rng.integers(2, 12, size=(B, 5)).astype(np.int32),
        "decoder_lengths": rng.integers(2, 6, size=B).astype(np.int32),
        "encoder_1_targets": rng.integers(0, 10, size=(B, T)).astype(np.int32),
    }
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out["subject_idx"] = 0
    return out


def step_mode(mode: str, device="cuda") -> float:
    """One step of ``mode`` over the world's ranks; returns the global
    loss after checking it against the one-process loss."""
    device = resolve_device(device)
    n_model, n_seq, n_pp, split_by, conformer = MODES[mode]
    mesh = make_mesh(n_model=n_model, n_seq=n_seq, n_pp=n_pp)
    config = _SEQ if conformer is None else dataclasses.replace(
        _SEQ, encoder_type="conformer", conformer=conformer)
    full = init_seq2seq(config, torch.Generator().manual_seed(0), device)
    batch = _batch(4 * mesh.shape["data"], 64, device)
    with torch.no_grad():
        want = float(seq2seq_loss(full, config, batch, train=False)[0])
    placement = Placement(mesh, full, tp=split_by == "tp", pp=n_pp > 1,
                          experts=conformer.moe_experts if split_by == "ep" else 0)
    params = placement.place(full)
    split = placement.split(params)
    parallel = placement.modes(microbatches=2)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    ema = tree_map(lambda t: t.detach().clone(), params)
    step = make_dp_train_step(
        lambda p, b, g: seq2seq_loss(p, config, b, g, train=False, **parallel),
        0.99, mesh, clip_norm=10.0, split=split)
    loss, _ = step(params, ema, torch.optim.Adam(tree_leaves(params), lr=1e-3), batch)
    np.testing.assert_allclose(float(loss), want, rtol=1e-4, err_msg=mode)
    return float(loss)


def dryrun_multichip(device="cuda") -> dict:
    """Every mode whose mesh divides the world, one step each (run on
    every rank of an initialised world)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    return {mode: step_mode(mode, device) for mode, (m, s, p, _, _) in MODES.items()
            if world % (m * s * p) == 0}


def main(argv=None) -> None:
    from .launch import spawn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    ranks = spawn("ecog2txt_tpu_torch.parallel.dryrun:dryrun_multichip", args.world,
                  {"device": args.device}, device=args.device)
    for mode, loss in ranks[0].items():
        print(f"{mode}: loss {loss:.6f} on {args.world} ranks")


if __name__ == "__main__":
    main()
