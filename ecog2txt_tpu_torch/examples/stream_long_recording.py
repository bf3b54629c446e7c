"""Stream a long continuous ECoG recording through the conformer, chunk by
chunk: the twin of ``examples/stream_long_recording.py``.

    python -m ecog2txt_tpu_torch.examples.stream_long_recording /tmp/stream
        [--sentences 8] [--packet 57] [--epochs 120] [--ctc] [--device cuda|cpu]

Trains a small conformer seq2seq on the synthetic corpus, then replays a
continuous recording (sentence after sentence of raw samples, arriving in
packets of ``--packet`` samples) through
``serve.StreamingConformerSession``: each whole attention chunk is
convolved and encoded as it fills, in a fixed window, and at each
sentence's end the session decodes and is reset.  Every sentence's
streamed tokens must equal the offline greedy decode of that trial
(exit 1 otherwise).  ``--ctc`` adds a CTC phoneme head and prints the live
``partial()`` phonemes whenever a new encoder chunk lands (outside the
timed region).

On the card every conformer LayerNorm runs K5f (K5b in training); under
``SN_kwargs={'conformer': {'attention_impl': 'flash'}}`` the attention runs
K2f (K2b-dq and K2b-dkv in training).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..demo import make_demo_experiment
from ..models.seq2seq import greedy_decode
from ..serve import StreamingConformerSession
from ..tokenizers import target_inds_to_sequences
from ..train import MultiSubjectTrainer


def build(workdir: str, epochs: int = 120, ctc: bool = False, device="cuda",
          SN_kwargs: dict | None = None, **experiment) -> MultiSubjectTrainer:
    """The demo experiment under ``workdir/exp`` and its conformer
    trainer, as the JAX script builds them; ``experiment`` goes to
    ``make_demo_experiment`` (sizes, trials)."""
    manifest = make_demo_experiment(
        os.path.join(workdir, "exp"), subject_ids=(1,),
        **({"phoneme_sequence_distribution": "CTC"} if ctc else {}), **experiment,
    )
    return MultiSubjectTrainer(
        manifest,
        [1],
        SN_kwargs={
            "batch_size": 16,
            "max_dec_len": 10,
            "learning_rate": 3e-3,
            "N_epochs": epochs,
            "encoder_type": "conformer",
            **(SN_kwargs or {}),
        },
        VERBOSE=False,
        device=device,
    )


def main(argv=None, **overrides) -> dict:
    """Run the example; returns the trainer, ``final_training_wer``,
    ``sentences`` (each ``{'streamed', 'offline', 'tokens', 'exact'}``),
    ``matches`` and ``rtf_warm``.  Raises ``SystemExit(1)`` unless every
    streamed decode equals the offline one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--sentences", type=int, default=8)
    ap.add_argument("--packet", type=int, default=57)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument(
        "--ctc", action="store_true",
        help="add a CTC phoneme head and print LIVE partial hypotheses "
             "while each sentence streams",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = build(args.workdir, args.epochs, args.ctc, args.device, **overrides)
    print(f"training conformer for {args.epochs} epochs ...")
    history = trainer.fit()
    last = list(history.values())[-1]
    print(f"  final training WER {last['training']['word_error_rate']:.3f}")

    ds = trainer.packed_dataset("validation")
    manifests = trainer.target_subject.data_manifests
    dec_list = manifests["decoder_targets"].feature_list
    phoneme_list = manifests["encoder_1_targets"].feature_list if args.ctc else None
    subject_idx = len(trainer.ecog_subjects) - 1
    params = trainer.full_params()
    session = StreamingConformerSession(
        params, trainer.net_config, dec_list, subject_idx=subject_idx,
        phoneme_list=phoneme_list, device=trainer.device,
    )

    n = min(args.sentences, int(ds.num_trials.sum()))
    sentences = []
    rtfs = []  # per-sentence real-time factor (the first includes warm-up)
    sr = float(trainer.target_subject.manifest.resolve("sampling_rate", default=200))
    for i in range(n):
        T = int(ds.encoder_lengths[0][i])
        raw = np.asarray(ds.encoder_inputs[0][i][:T], np.float32)
        # offline decode of the same single trial
        with torch.inference_mode():
            offline = greedy_decode(
                params, trainer.net_config,
                torch.from_numpy(np.asarray(ds.encoder_inputs[0][i])[None]).to(trainer.device),
                torch.tensor([T], dtype=torch.int32, device=trainer.device),
                subject_idx, temperature=0.0,
            )[0].cpu().numpy()
        push_time = 0.0
        last_steps = 0
        for start in range(0, T, args.packet):  # ragged packet arrival
            t0 = time.perf_counter()
            session.push(raw[start: start + args.packet])
            push_time += time.perf_counter() - t0
            if args.ctc:
                p = session.partial()  # LIVE phonemes (untimed)
                if p["num_steps"] > last_steps:  # a new chunk landed
                    last_steps = p["num_steps"]
                    print(f"      …{session.num_samples:4d} samples: "
                          + " ".join(p["phonemes"][0][-8:]))
        t0 = time.perf_counter()
        out = session.endpoint()
        push_time += time.perf_counter() - t0
        rtfs.append((T / sr) / push_time)
        hyp = out["sequences"][0]
        ref = target_inds_to_sequences(offline[None], dec_list)[0]
        ok = bool(np.array_equal(out["tokens"][0], offline))
        sentences.append({"streamed": hyp, "offline": ref, "tokens": out["tokens"][0],
                          "exact": ok})
        print(f"  [{i}] streamed={hyp!r}  offline={ref!r}  exact={ok}")
        session.reset()

    matches = sum(s["exact"] for s in sentences)
    warm_rtfs = rtfs[1:] or rtfs
    warm = sorted(warm_rtfs)[len(warm_rtfs) // 2]
    print(
        f"{n} sentences; median warm real-time factor {warm:.1f}x "
        f"(first sentence incl. warm-up: {rtfs[0]:.2f}x); "
        f"streamed == offline for {matches}/{n}"
    )
    if matches != n:
        sys.exit(1)
    return {"trainer": trainer, "final_training_wer": last["training"]["word_error_rate"],
            "sentences": sentences, "matches": matches, "rtf_warm": warm}


if __name__ == "__main__":
    main()
