"""End-to-end demo on the port: synthetic experiment → train → assess.

    python -m ecog2txt_tpu_torch.run_demo [workdir] [--epochs N] [--subjects K]
        [--attention] [--conformer] [--ctc] [--data-parallel] [--beam W]
        [--device cuda|cpu] [--use-pallas-lstm False|True|bi_grid]
    torchrun --nproc-per-node 2 -m ecog2txt_tpu_torch.run_demo --data-parallel

The twin of ``examples/run_demo.py``: build the trainer from the demo
manifest, write the records, train with periodic assessment
(``parallel_transfer_learn``), assess the validation and testing blocks,
run the analysis step (the target subject's electrode contributions by
weight norms, ``plotting.ResultsPlotter.elec_contribs``) and serve one
trial online.  At the default 100 epochs the demo reaches WER 0.

``--data-parallel`` trains over the ranks that ``torchrun`` (or the
trainer's ``distributed`` key) gives, each rank a slice of every batch,
and in one process when there are none; only rank 0 prints.  The run is
on the card unless ``--device cpu``; ``--use-pallas-lstm`` is the
trainer's key of that name (True or 'bi_grid' runs the biLSTM on the
Hopper kernels).
"""

from __future__ import annotations

import argparse
import os
import tempfile


def _pallas_flag(value: str):
    return {"False": False, "True": True}.get(value, value)


def main(argv=None) -> dict:
    """Run the demo; returns the final assessment ``{partition: snapshot}``
    and, under ``"elec_contribs"``, the (num_channels,) electrode
    contributions by weight norms."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("workdir", nargs="?", default=None)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--subjects", type=int, default=1)
    parser.add_argument("--attention", action="store_true")
    parser.add_argument("--conformer", action="store_true")
    parser.add_argument("--ctc", action="store_true")
    parser.add_argument("--data-parallel", action="store_true")
    parser.add_argument("--beam", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--use-pallas-lstm", type=_pallas_flag, default=False)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from .demo import make_demo_experiment
    from .parallel.multihost import initialize_from_environment
    from .plotting import ResultsPlotter
    from .serve import OnlinePredictor
    from .train import MultiSubjectTrainer

    overrides = {}
    if args.attention:
        overrides["cross_attention"] = True
    if args.conformer:
        overrides["encoder_type"] = "conformer"
    if args.ctc:
        overrides["phoneme_sequence_distribution"] = "CTC"
    subject_ids = tuple(range(1, args.subjects + 1))

    # under torchrun rank 0 writes the experiment and the other ranks read
    # it: its directory goes to them, and they wait until it is complete
    if args.data_parallel:
        initialize_from_environment(args.device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    manifest = [None]
    if rank0:
        workdir = args.workdir or tempfile.mkdtemp(prefix="ecog2txt_demo_")
        manifest[0] = make_demo_experiment(
            os.path.join(workdir, "exp"), subject_ids=subject_ids, N_epochs=args.epochs,
            **overrides,
        )
        say(f"experiment at {workdir}")
    if dist.is_initialized():
        dist.broadcast_object_list(manifest, src=0)
    trainer = MultiSubjectTrainer(
        manifest[0], list(subject_ids), VERBOSE=rank0, device=args.device,
        SN_kwargs={
            "batch_size": 16,
            "max_dec_len": 10,
            "learning_rate": 3e-3,
            "beam_width": args.beam,
            "data_parallel": args.data_parallel,
            "use_pallas_lstm": args.use_pallas_lstm,
        },
    )
    if trainer.mesh is not None:
        say(f"data parallel over {trainer.mesh.shape['data']} ranks")
    trainer.parallel_transfer_learn()

    out = trainer.assess(["validation", "testing"])
    for partition, snap in out.items():
        say(f"{partition}: WER {snap['word_error_rate']:.3f} accuracy {snap['accuracy']:.3f}")
    say("example decodes:")
    for ref, hyp in zip(out["validation"]["references"][:3], out["validation"]["hypotheses"][:3]):
        say(f"  ref: {ref!r}\n  hyp: {hyp!r}")

    # analysis hooks
    plotter = ResultsPlotter(trainer.target_subject, trainer, VERBOSE=False)
    contribs = plotter.elec_contribs("weight_norms")
    say(f"electrode contributions (weight norms): {contribs.round(2)}")
    predictor = OnlinePredictor.from_trainer(trainer)
    ds = trainer.packed_dataset("testing")
    trial = ds.encoder_inputs[0, 0, : int(ds.encoder_lengths[0, 0])]
    say("online predict:", predictor(trial)["sequences"])
    return {**out, "elec_contribs": contribs}


if __name__ == "__main__":
    main()
