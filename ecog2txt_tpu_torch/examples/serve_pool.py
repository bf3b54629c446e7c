"""Multi-tenant streaming serving: N concurrent live streams through one
``StreamingSessionPool``; the twin of ``examples/serve_pool.py``.

    python -m ecog2txt_tpu_torch.examples.serve_pool [workdir] [--streams 3]
        [--epochs 60] [--device cuda|cpu]

Trains a small conformer on the synthetic corpus, then plays validation
utterances as concurrent streams with different start times (stream i
joins after i·17 samples of stream 0) and ragged packets of 23 samples
through one pool, and checks every final hypothesis against (a) a
dedicated single-stream session and (b) the offline batch decode: all
three must agree exactly (exit 1 otherwise).

The pool pins the window's attention to the plain 'dense' (or 'banded')
path for its per-row offsets; on the card its LayerNorms run K5f, and
training runs K5f and K5b.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..demo import make_demo_experiment
from ..serve import StreamingConformerSession, StreamingSessionPool
from ..train import MultiSubjectTrainer

PACKET = 23  # samples a packet
STAGGER = 17  # samples of stream 0 played before stream i joins, times i


def build(workdir: str, epochs: int = 60, device="cuda", SN_kwargs: dict | None = None,
          **experiment) -> MultiSubjectTrainer:
    """The conformer demo experiment under ``workdir/exp`` and its trainer,
    as the JAX script builds them; ``experiment`` goes to
    ``make_demo_experiment``."""
    manifest = make_demo_experiment(
        os.path.join(workdir, "exp"), subject_ids=(1,),
        encoder_type="conformer", N_epochs=epochs, **experiment,
    )
    return MultiSubjectTrainer(
        manifest, [1],
        SN_kwargs={"batch_size": 16, "max_dec_len": 10,
                   "learning_rate": 3e-3, "temperature": 0.0, **(SN_kwargs or {})},
        VERBOSE=False, device=device,
    )


def play(pool: StreamingSessionPool, sessions: list, utts: list) -> dict:
    """Interleaved ragged playback of ``utts`` through the pool and one
    dedicated session each; returns ``{stream: slot}``."""
    n = len(utts)
    slots, pos = {}, {i: 0 for i in range(n)}
    t = 0
    while any(pos[i] < len(utts[i]) for i in range(n)):
        for i in range(n):
            if i not in slots and t >= i * STAGGER:
                slots[i] = pool.add()
            if i in slots and pos[i] < len(utts[i]):
                pkt = utts[i][pos[i]: pos[i] + PACKET]
                pool.push(slots[i], pkt)
                sessions[i].push(pkt)
                pos[i] += len(pkt)
        t += PACKET
    return slots


def main(argv=None, **overrides) -> dict:
    """Run the example; returns the trainer and ``streams`` (each
    ``{'pooled', 'single', 'offline', 'tokens', 'agree'}``).  Raises
    ``SystemExit(1)`` unless every stream agrees."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("workdir", nargs="?", default=None)
    parser.add_argument("--streams", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="ecog2txt_pool_")
    trainer = build(workdir, args.epochs, args.device, **overrides)
    print("training…")
    trainer.fit(assess=False)

    ds = trainer.packed_dataset("validation")
    n = min(args.streams, int(ds.num_trials[0]))
    utts = [np.asarray(ds.encoder_inputs[0, i, : int(ds.encoder_lengths[0, i])], np.float32)
            for i in range(n)]

    pool = StreamingSessionPool.from_trainer(trainer, capacity=n)
    sessions = [StreamingConformerSession.from_trainer(trainer) for _ in range(n)]
    offline = trainer.assess(["validation"])["validation"]["hypotheses"]
    slots = play(pool, sessions, utts)

    streams = []
    for i in range(n):
        out = pool.endpoint(slots[i])
        got = out["sequences"][0]
        single = sessions[i].endpoint()["sequences"][0]
        agree = got == single == offline[i]
        streams.append({"pooled": got, "single": single, "offline": offline[i],
                        "tokens": out["tokens"][0], "agree": agree})
        print(f"stream {i}: pooled='{got}' single='{single}' "
              f"offline='{offline[i]}' agree={agree}")
    ok = sum(s["agree"] for s in streams)
    print(f"{ok}/{n} streams: pooled == dedicated == offline")
    if ok != n:
        raise SystemExit(1)
    return {"trainer": trainer, "streams": streams}


if __name__ == "__main__":
    main()
