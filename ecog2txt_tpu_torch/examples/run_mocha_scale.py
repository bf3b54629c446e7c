"""Reference-scale end-to-end run: the twin of ``examples/run_mocha_scale.py``.

    python -m ecog2txt_tpu_torch.examples.run_mocha_scale /tmp/mocha [--epochs 400]
        [--batch-size 128] [--no-pallas] [--device cuda|cpu]

The full MOCHA-TIMIT-style experiment on synthetic data: a 16×16 grid,
50 unique sentences, 9 training blocks × 50 trials, the reference
architecture (conv [100] at stride 12 → 3×400 biLSTM → aux [225] →
decoder 150 / LSTM 800), a 400-epoch schedule with an EMA assessment
every 10 epochs, B=128, bf16 and ``use_pallas_lstm=True``: on the card
each training step runs the recurrence kernels K1f and K1b 6 times (3
layers × 2 directions) and each assessment encode K1f 6 times.
``--no-pallas`` runs the plain step loops in f32.

Prints the wall time of ``parallel_transfer_learn`` (after the training
data is written, packed and uploaded, which is timed apart), the final
training and validation WERs, the first assessment at which both are 0,
and the mean step time (the wall time less the assessments', over the
steps).
"""

from __future__ import annotations

import argparse
import time

from ..demo import make_demo_experiment
from ..train import MultiSubjectTrainer

REFERENCE_LAYERS = {
    # mocha-1_word_sequence.yaml:56-69
    "encoder_embedding": [100],
    "encoder_rnn": [400, 400, 400],
    "encoder_1_projection": [225],
    "decoder_embedding": [150],
    "decoder_rnn": [800],
    "decoder_projection": [],
}


def build(root: str, epochs: int = 400, batch_size: int = 128, no_pallas: bool = False,
          device="cuda", grid_size=(16, 16), num_unique_sentences: int = 50,
          num_sentences_per_block: int = 50, num_training_blocks: int = 9,
          layer_sizes: dict | None = None,
          SN_kwargs: dict | None = None) -> MultiSubjectTrainer:
    """The experiment under ``root`` and its trainer, as the JAX script
    builds them; the keywords after ``device`` cut it down."""
    manifest_path = make_demo_experiment(
        root,
        subject_ids=(1,),
        grid_size=tuple(grid_size),
        num_unique_sentences=num_unique_sentences,
        num_sentences_per_block=num_sentences_per_block,
        num_training_blocks=num_training_blocks,
        N_epochs=epochs,
        layer_sizes=layer_sizes or REFERENCE_LAYERS,
    )
    return MultiSubjectTrainer(
        manifest_path,
        [1],
        SN_kwargs={
            "batch_size": batch_size,
            "max_dec_len": 12,
            "learning_rate": 1e-3,
            "use_pallas_lstm": not no_pallas,
            "compute_dtype": "float32" if no_pallas else "bfloat16",
            "temperature": 0.0,
            **(SN_kwargs or {}),
        },
        VERBOSE=True,
        device=device,
    )


def steps_per_epoch(trainer: MultiSubjectTrainer) -> int:
    """Training steps in one epoch: ⌈trials / B⌉ a subject, as ``fit``."""
    counts = trainer.packed_dataset("training").num_trials
    return sum(-(-int(n) // trainer.batch_size) for n in counts if n > 0)


def main(argv=None, **overrides) -> dict:
    """Run the experiment; returns the trainer, the assessment history,
    ``wall_s`` (``parallel_transfer_learn``), ``setup_s`` (the training
    data's), ``assess_s`` (the assessments'), ``steps``, ``step_ms``,
    ``epochs_to_wer_0`` (None when never) and the final ``wers``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", help="experiment directory")
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument(
        "--no-pallas", action="store_true",
        help="use the plain step loops in f32 (e.g. on the CPU)",
    )
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    trainer = build(args.root, args.epochs, args.batch_size, args.no_pallas, args.device,
                    **overrides)
    # the assessments' wall time, to take it out of the mean step time
    # (an assessment returns host values, so its device work is done)
    assess, assess_s = trainer.assess, []

    def timed_assess(*a, **kw):
        t = time.perf_counter()
        out = assess(*a, **kw)
        assess_s.append(time.perf_counter() - t)
        return out

    trainer.assess = timed_assess
    t0 = time.perf_counter()
    trainer.device_data("training")  # the records written, packed and uploaded
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    history = trainer.parallel_transfer_learn()
    wall = time.perf_counter() - t0
    del trainer.assess
    last = list(history.values())[-1]
    wers = {p: last[p]["word_error_rate"] for p in ("training", "validation")}
    epochs_to_wer_0 = next(
        (int(e) for e, snap in history.items()
         if snap["training"]["word_error_rate"] == snap["validation"]["word_error_rate"] == 0),
        None,
    )
    steps = args.epochs * steps_per_epoch(trainer)
    step_ms = 1e3 * (wall - sum(assess_s)) / steps
    print(
        f"{args.epochs} epochs + {len(history)} assessments: "
        f"{wall:.1f}s wall; final train/val WER "
        f"{wers['training']:.3f}/{wers['validation']:.3f}"
    )
    print(f"train and val WER 0 from epoch {epochs_to_wer_0}; {steps} steps, mean "
          f"{step_ms:.2f} ms a step; assessments {sum(assess_s):.1f}s; data set-up "
          f"{setup:.1f}s")
    return {"trainer": trainer, "history": history, "wall_s": wall, "setup_s": setup,
            "assess_s": sum(assess_s), "steps": steps, "step_ms": step_ms,
            "epochs_to_wer_0": epochs_to_wer_0, "wers": wers}


if __name__ == "__main__":
    main()
