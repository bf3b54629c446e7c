"""The port's twins of the user entry points in ``examples/``.

One module a script, with the script's name, arguments and defaults and
every check it makes; each runs as ``python -m
ecog2txt_tpu_torch.examples.<name> ...``, on the card unless given
``--device cpu``:

    run_mocha_scale        — the reference-scale experiment (16×16 grid,
                             3×400 biLSTM, 450 trials, B=128, bf16, K1f/K1b)
    stream_long_recording  — a conformer streamed sentence by sentence,
                             each decode equal to the offline one
    serve_pool             — concurrent ragged streams through one
                             ``StreamingSessionPool``
    raw_voltage_demo       — raw-voltage trials featurized inside
                             ``ArrayDataGenerator``, streamed featurization
    moe_expert_parallel    — a MoE conformer, its experts over the ranks
                             of ``torchrun`` / ``parallel.launch.spawn``
    migrate_from_reference — manifest, vocab and a TF1 checkpoint of the
                             reference, then fit, assess, serve, export

The demo (``examples/run_demo.py``) is ``ecog2txt_tpu_torch.run_demo``.
Each module has ``main(argv=None, **overrides) -> dict`` and a ``build``
function that ``main`` calls with ``overrides`` (narrower layers, fewer
trials, ``SN_kwargs`` keys of the trainer), for tests and smoke runs.
"""
