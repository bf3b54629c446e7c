"""Mixture-of-experts conformer with expert parallelism: the twin of
``examples/moe_expert_parallel.py``.

    python -m ecog2txt_tpu_torch.examples.moe_expert_parallel [workdir]
        [--epochs 60] [--device cuda|cpu]
    torchrun --nproc-per-node 4 -m ecog2txt_tpu_torch.examples.moe_expert_parallel

Trains a MoE conformer (4 routed experts, top-2 gating, no-drop) on the
synthetic corpus.  On a world of 4 ranks or more (``torchrun``, or
``parallel.launch.spawn``) the expert axis is split over 4 ranks
(``SN_kwargs`` ``data_parallel`` and ``expert_parallel=4``: each rank holds
its experts and their Adam moments, everything else replicated); with
fewer it trains in one process.  Then a validation utterance streams
through ``StreamingConformerSession`` in packets of 37 samples on the
trained (gathered) weights, and its tokens must equal the offline greedy
decode exactly: the no-drop MoE routes each token on its own, so the
streamed == offline contract survives the routing.  Only rank 0 prints.

On the card every LayerNorm runs K5f (K5b in training).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..convert import params_to_numpy
from ..demo import make_demo_experiment
from ..models.seq2seq import greedy_decode
from ..parallel.multihost import initialize_from_environment
from ..serve import StreamingConformerSession
from ..train import MultiSubjectTrainer

CONFORMER = {
    "num_blocks": 2, "model_dim": 32, "num_heads": 2,
    "ffn_dim": 64, "chunk_size": 4, "left_context": 1,
    "conv_kernel": 4, "moe_experts": 4, "moe_topk": 2,
}
PACKET = 37  # raw samples a streamed packet


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def build(workdir: str, device="cuda", SN_kwargs: dict | None = None,
          **experiment) -> MultiSubjectTrainer:
    """The demo experiment and the MoE trainer, as the JAX script builds
    them: the experts over 4 ranks where the world has 4 or more.  Under
    ranks rank 0 writes the experiment and the others read it."""
    initialize_from_environment(device)  # under torchrun; nothing otherwise
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    n_ep = 4 if _world_size() >= 4 else 1
    sn = {
        "encoder_type": "conformer",
        "batch_size": 16,
        "temperature": 0.0,
        "learning_rate": 3e-3,
        "conformer": dict(CONFORMER),
    }
    if n_ep > 1:
        sn["data_parallel"] = True
        sn["expert_parallel"] = n_ep
    sn.update(SN_kwargs or {})
    manifest = [make_demo_experiment(workdir, subject_ids=(1,), **experiment) if rank0
                else None]
    if dist.is_initialized():
        dist.broadcast_object_list(manifest, src=0)
    return MultiSubjectTrainer(manifest[0], [1], SN_kwargs=sn, VERBOSE=rank0, device=device)


def streamed_and_offline(trainer: MultiSubjectTrainer) -> dict:
    """The first validation utterance streamed through a session and
    decoded offline (padded to the conv's multiple), on the gathered EMA
    weights: ``{'streamed', 'offline', 'sequences'}`` (tokens as arrays)."""
    params = trainer.full_params()
    cfg = trainer.net_config
    dec_list = trainer.target_subject.data_manifests["decoder_targets"].feature_list
    dev = trainer.device_data("validation")
    raw = dev["encoder_inputs"][0][0].float().cpu().numpy()
    L = int(dev["encoder_lengths"][0][0])
    d = cfg.decimation_factor
    T = ((L + d - 1) // d) * d
    inputs = np.zeros((1, T, raw.shape[-1]), np.float32)
    inputs[:, :L] = raw[:L]
    with torch.inference_mode():
        off = greedy_decode(
            params, cfg, torch.from_numpy(inputs).to(trainer.device),
            torch.tensor([L], dtype=torch.int32, device=trainer.device), 0, temperature=0.0,
        ).cpu().numpy()
    sess = StreamingConformerSession(params, cfg, dec_list, device=trainer.device)
    for lo in range(0, L, PACKET):
        sess.push(raw[lo:lo + PACKET])
    out = sess.endpoint()
    return {"streamed": np.asarray(out["tokens"]), "offline": off,
            "sequences": out["sequences"]}


def main(argv=None, **overrides) -> dict:
    """Run the example; returns (picklable, for a rank's result) the
    ``mesh`` shape (None in one process), ``history``, ``final_wer``, the
    streamed and offline ``tokens``, ``sequences`` and the trained EMA
    ``params`` as numpy (experts gathered).  Raises ``AssertionError``
    when the streamed decode differs from the offline one."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("workdir", nargs="?", default=None)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="moe_demo_")

    trainer = build(workdir, args.device, **overrides)
    say = trainer.vprint
    if trainer.mesh is not None:
        say(f"mesh: {dict(trainer.mesh.shape)} (experts split over 'model'; Adam "
            "moments too)")
    history = trainer.fit(num_epochs=args.epochs)
    last = history[list(history)[-1]]
    say(f"final val WER: {last['validation']['word_error_rate']:.3f}")

    # streamed == offline on the trained MoE weights
    got = streamed_and_offline(trainer)
    assert np.array_equal(got["streamed"], got["offline"]), (
        "streamed MoE decode diverged from offline"
    )
    say(f"streamed == offline: {got['sequences']!r}")
    return {"mesh": dict(trainer.mesh.shape) if trainer.mesh is not None else None,
            "history": {e: {p: s["word_error_rate"] for p, s in snap.items()}
                        for e, snap in history.items()},
            "final_wer": last["validation"]["word_error_rate"],
            "tokens": got["streamed"], "offline": got["offline"],
            "sequences": got["sequences"],
            "params": params_to_numpy(trainer.full_params())}


if __name__ == "__main__":
    main()
