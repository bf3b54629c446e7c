"""Raw-voltage walkthrough: 1 kHz amplifier output in, decoded text out,
with no featurization code of the user's; the twin of
``examples/raw_voltage_demo.py``.

    python -m ecog2txt_tpu_torch.examples.raw_voltage_demo [workdir]
        [--epochs 150] [--device cuda|cpu]

A probe experiment supplies the sentence corpus and each trial's
word-pattern envelope; every trial is written as raw voltage
(``features.synthesize_raw_from_envelope``: band-noise carrier × envelope
+ 60 Hz line noise + a broadband floor, from ``default_rng(0)``) into
``.npz`` files, so the only decodable signal is what the featurization
chain must recover.  The manifest's ``high_gamma`` block then runs that
chain (notch → log-spaced band-pass bank → analytic amplitude → z-score
→ decimate, ``features.extract_high_gamma``) inside
``datagen.ArrayDataGenerator`` while the trainer reads the files.  Last,
the same chain streams incrementally (``features.StreamingHighGamma``) in
ragged chunks and must equal the offline chain to 1e-3; the validation
WER must be at most 0.25.

At the defaults the encoder is a biLSTM on the plain step loops; under
``SN_kwargs={'use_pallas_lstm': 'bi_grid'}`` it runs K4f and K4b on the
card (``True``: K1f and K1b).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from dataclasses import replace

import numpy as np

from ..demo import make_demo_experiment
from ..features import (
    HighGammaConfig,
    StreamingHighGamma,
    extract_high_gamma_np,
    synthesize_raw_from_envelope,
)
from ..train import MultiSubjectTrainer

RAW_RATE = 1000.0
HG = {"num_bands": 6, "pad_seconds": 0.25}  # the manifest's high_gamma block


def write_raw_trials(workdir: str, device="cuda", **experiment) -> tuple:
    """Every trial of the probe experiment (``experiment`` goes to its
    ``make_demo_experiment``) as a raw-voltage ``.npz`` under
    ``workdir/raw_trials/B<block>/``; returns ``(raw_dir, cfg, gen, rng,
    n_trials)``, ``rng`` the generator the trials drew from."""
    raw_dir = os.path.join(workdir, "raw_trials")
    probe_path = make_demo_experiment(os.path.join(workdir, "probe"), subject_ids=(1,),
                                      **experiment)
    probe = MultiSubjectTrainer(probe_path, [1], VERBOSE=False, device=device)
    gen = probe.ecog_subjects[0].data_generator
    rng = np.random.default_rng(0)
    cfg = HighGammaConfig(raw_rate=RAW_RATE, out_rate=gen.sampling_rate, **HG)
    n_trials = 0
    for block in gen._all_blocks():
        block_dir = os.path.join(raw_dir, f"B{block}")
        os.makedirs(block_dir, exist_ok=True)
        for i, trial in enumerate(gen._ecog_token_generator(block)):
            env = np.asarray(trial["ecog_sequence"], np.float32)
            raw = synthesize_raw_from_envelope(env, cfg, rng)
            arrays = {
                "raw": raw, "raw_rate": RAW_RATE,
                "text": np.asarray(trial["text_sequence"]),
                "audio_features": np.asarray(trial["audio_sequence"], np.float32),
            }
            if trial.get("phoneme_sequence") is not None:
                arrays["phonemes"] = np.asarray(trial["phoneme_sequence"])
            np.savez(os.path.join(block_dir, f"{i:04d}.npz"), **arrays)
            n_trials += 1
    print(f"{n_trials} raw-voltage trials ({raw.shape[1]} ch @ {RAW_RATE:.0f} Hz, with "
          f"60 Hz line noise) → {raw_dir}")
    return raw_dir, cfg, gen, rng, n_trials


def build(workdir: str, raw_dir: str, epochs: int = 150, device="cuda",
          SN_kwargs: dict | None = None, **experiment) -> MultiSubjectTrainer:
    """The experiment that trains straight from the voltage files, and its
    trainer (featurizing on ``device``)."""
    manifest_path = make_demo_experiment(
        os.path.join(workdir, "exp"),
        subject_ids=(1,),
        N_epochs=epochs,
        DataGenerator="ArrayDataGenerator",
        trial_dir=raw_dir,
        raw_sampling_rate=RAW_RATE,
        high_gamma=HG,
        **experiment,
    )
    return MultiSubjectTrainer(
        manifest_path, [1],
        SN_kwargs={"batch_size": 16, "max_dec_len": 10, "learning_rate": 3e-3,
                   **(SN_kwargs or {})},
        DG_kwargs={"device": device},
        device=device,
    )


def streamed_vs_offline(cfg: HighGammaConfig, gen, rng, device="cuda") -> tuple[float, int]:
    """The first trial's envelope as raw voltage, featurized offline and
    pushed through ``StreamingHighGamma`` in chunks of 64-511 samples:
    (max |streamed − offline|, frames compared)."""
    stream_cfg = replace(cfg, zscore="none")
    env = next(iter(gen._ecog_token_generator(gen._all_blocks()[0])))["ecog_sequence"]
    raw = synthesize_raw_from_envelope(np.asarray(env, np.float32), stream_cfg, rng)
    offline = extract_high_gamma_np(raw, stream_cfg, device=device)
    stream = StreamingHighGamma(stream_cfg, raw.shape[1], device=device)
    chunks = []
    i = 0
    while i < len(raw):
        n = int(rng.integers(64, 512))
        chunks.append(stream.push(raw[i: i + n]))
        i += n
    chunks.append(stream.flush())
    streamed = np.concatenate(chunks)
    n = min(len(streamed), len(offline))
    return float(np.abs(streamed[:n] - offline[:n]).max()), n


def main(argv=None, **overrides) -> dict:
    """Run the walkthrough; returns the trainer, ``n_trials``, the final
    assessment ``out`` ({'validation', 'testing'}), ``wer`` (validation)
    and ``stream_err``.  ``overrides`` go to :func:`build`, and
    ``experiment`` among them to both experiments."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="ecog2txt_raw_")
    experiment = overrides.pop("experiment", {})
    # 1. the probe's trials re-expressed as raw voltage
    raw_dir, cfg, gen, rng, n_trials = write_raw_trials(workdir, args.device, **experiment)
    # 2. train straight from the voltage files
    trainer = build(workdir, raw_dir, args.epochs, args.device, **overrides, **experiment)
    trainer.parallel_transfer_learn()
    out = trainer.assess(["validation", "testing"])
    for part, snap in out.items():
        print(f"{part}: WER {snap['word_error_rate']:.3f} from raw voltage")
    # 3. the same chain, streamed: ragged chunks == offline, to float
    #    tolerance (what the serving sessions run)
    err, n = streamed_vs_offline(cfg, gen, rng, args.device)
    print(f"streamed featurization vs offline: max |Δ| = {err:.2e} over {n} frames")
    wer = out["validation"]["word_error_rate"]
    assert wer <= 0.25, f"raw-voltage training failed to learn: WER {wer}"
    assert err < 1e-3
    return {"trainer": trainer, "n_trials": n_trials, "out": out, "wer": wer,
            "stream_err": err}


if __name__ == "__main__":
    main()
