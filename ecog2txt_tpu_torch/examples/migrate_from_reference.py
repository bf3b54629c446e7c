"""Migration walkthrough for a user of the reference ecog2txt: the twin of
``examples/migrate_from_reference.py``.

    python -m ecog2txt_tpu_torch.examples.migrate_from_reference [workdir]
        [--text-dir DIR] [--manifest NAME] [--subject ID]
        [--tf1-ckpt PREFIX] [--epochs 20] [--device cuda|cpu]

Against the reference's own auxiliary files (``--text-dir
/path/to/ecog2txt/auxiliary/EFC``) or the packaged ``auxiliary/``:

1. the unchanged experiment manifest YAML and ``block_breakdowns.json``
   load (``!!python/name:`` tags resolve through the registry; only the
   lab's write paths are pointed at ``workdir``);
2. vocab files resolve by the reference's 4-level rule;
3. a pre-trained TF1 ``model.ckpt-<epoch>`` imports onto the live
   parameters; ``rebuild='auto'`` rebuilds the architecture from the
   checkpoint's tensor shapes first when a complete checkpoint disagrees
   with the constructed one.  Without ``--tf1-ckpt`` a stand-in source is
   made and named: with tensorflow, a tiny TF1 checkpoint file (one
   projection variable under the reference's scope grammar, as the JAX
   script writes); without it, the trainer's own parameters and EMA as
   variables of that grammar (``utils.tf1_import.tf1_variables_from_params``).

Then it trains, assesses, predicts one utterance online and exports the
predictor with ``torch.export`` (``serve.export_predictor``); the program
loaded back (``serve.load_exported_predictor``) must give the predictor's
tokens.  The subject table needs pandas and is printed where it is
installed.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..serve import OnlinePredictor, export_predictor, load_exported_predictor
from ..train import MultiSubjectTrainer
from ..utils.tf1_import import read_tf1_checkpoint, recover_model_sizes, tf1_variables_from_params


def build(workdir: str, manifest: str = "demo_word_sequence.yaml", subject: int = 1,
          text_dir: str | None = None, device="cuda",
          SN_kwargs: dict | None = None) -> MultiSubjectTrainer:
    """The reference's constructor contract, unchanged: a manifest name and
    a subject list, with ``DG_kwargs`` pointing only the lab's write
    paths at ``workdir``."""
    return MultiSubjectTrainer(
        manifest,
        [subject],
        text_dir=text_dir,
        SN_kwargs={"batch_size": 16, "max_dec_len": 10,
                   "learning_rate": 3e-3,
                   # the recurrence kernels (K1f, K1b on the card), so that
                   # the exported program calls K1f as one operator a layer
                   # and direction; the step loop would be traced step by step
                   "use_pallas_lstm": True,
                   "checkpoint_dir": os.path.join(workdir, "ckpt"),
                   # the manifest's tf_summaries_dir is a lab path; the
                   # TensorBoard curves go into the workdir
                   "tf_summaries_dir": os.path.join(workdir, "tb"),
                   **(SN_kwargs or {})},
        DG_kwargs={"tf_record_partial_path": os.path.join(workdir, "records",
                                                          "block_{0}.tfrecord")},
        VERBOSE=True,
        device=device,
    )


def _reference_leaves(tree: dict) -> dict:
    """The tree without the decoder's bridge (a layer between the encoder's
    final state and a decoder of another width), which the reference's
    grammar has no name for; the import leaves it as constructed."""
    decoder = {k: v for k, v in tree["decoder"].items() if not k.startswith("bridge_")}
    return {**tree, "decoder": decoder}


def standin_tf1_source(trainer: MultiSubjectTrainer, workdir: str) -> tuple:
    """A TF1 source when the user gives none: ``(path or mapping, what)``.
    With tensorflow, a real TF1-format checkpoint of one transposed
    projection variable (random, seed 0) under the reference's scope
    grammar; without it, the trainer's parameters and EMA as a mapping of
    the reference's variables (every leaf the grammar names)."""
    try:
        import tensorflow as tf
    except ImportError:
        variables = tf1_variables_from_params(
            _reference_leaves(trainer.full_params(False)), trainer.net_config.conv_strides,
            trainer.subject_ids, _reference_leaves(trainer.full_params()),
        )
        return variables, ("stand-in: the trainer's parameters as variables of the "
                           "reference's grammar (tensorflow is not installed)")
    tf1 = tf.compat.v1
    cfg = trainer.net_config
    D = cfg.dec_rnn_sizes[-1]
    w = np.random.default_rng(0).normal(size=(cfg.vocab_size, D)).astype(np.float32) * 0.05
    os.makedirs(os.path.join(workdir, "tf1"), exist_ok=True)
    graph = tf1.Graph()
    with graph.as_default():
        var = tf1.get_variable("v0", initializer=tf.constant(w))
        saver = tf1.train.Saver(
            var_list={f"seq2seq/decoder_projection_{D}_{cfg.vocab_size}_0/weights": var}
        )
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            path = saver.save(sess, os.path.join(workdir, "tf1", "model.ckpt"),
                              global_step=200)
    return path, f"stand-in: a TF1 checkpoint file written with tensorflow at {path}"


def main(argv=None, **overrides) -> dict:
    """Run the walkthrough; returns the trainer, ``tf1_source`` (what was
    imported), ``recovered`` (``recover_model_sizes`` of it), the import
    ``report``, ``wer`` (validation), the predictor's and the exported
    program's ``tokens`` and the ``artifact`` path.  Raises
    ``AssertionError`` when the exported program's tokens differ."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("workdir", nargs="?", default=None)
    parser.add_argument("--text-dir", default=None,
                        help="reference auxiliary dir (default: packaged)")
    parser.add_argument("--manifest", default="demo_word_sequence.yaml",
                        help="manifest name, e.g. EFC/mocha-1_word_sequence.yaml")
    parser.add_argument("--subject", type=int, default=1)
    parser.add_argument("--tf1-ckpt", default=None,
                        help="TF1 model.ckpt-<epoch> prefix to import")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="ecog2txt_migrate_")
    # 1+2) the manifest, block breakdowns and vocab files, as the reference
    trainer = build(workdir, args.manifest, args.subject, args.text_dir, args.device,
                    **overrides)
    try:
        print(trainer.subject_to_table())
    except ImportError:
        print("pandas is not installed: the subject table is not printed")

    # 3) TF1 checkpoint import (architecture recovered from tensor shapes
    # when a complete checkpoint differs from the constructed net)
    if args.tf1_ckpt is not None:
        source, what = args.tf1_ckpt, f"--tf1-ckpt {args.tf1_ckpt}"
    else:
        source, what = standin_tf1_source(trainer, workdir)
    variables = read_tf1_checkpoint(source) if isinstance(source, str) else source
    print(f"TF1 source: {what}")
    report = trainer.import_tf1_checkpoint(variables)  # prints what it imported

    trainer.fit(num_epochs=args.epochs)
    out = trainer.assess(["validation"])
    wer = out["validation"]["word_error_rate"]
    print(f"validation WER {wer:.3f}")

    predictor = OnlinePredictor.from_trainer(trainer)
    ds = trainer.packed_dataset("validation")
    one = np.asarray(ds.encoder_inputs[0, 0, : int(ds.encoder_lengths[0, 0])])
    live = predictor(one)
    print("one-utterance prediction:", live["sequences"][0])

    artifact = export_predictor(predictor, os.path.join(workdir, "exported"))
    exported = load_exported_predictor(artifact)(one)
    assert np.array_equal(exported["tokens"], live["tokens"]), (
        "the exported program's tokens differ from the predictor's"
    )
    print(f"torch.export serving artifact at {artifact}: tokens equal the predictor's")
    return {"trainer": trainer, "tf1_source": what, "recovered": recover_model_sizes(variables),
            "report": report, "wer": wer, "tokens": live["tokens"],
            "exported_tokens": exported["tokens"], "artifact": artifact}


if __name__ == "__main__":
    main()
