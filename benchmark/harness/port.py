"""The program under test, ``ecog2txt_tpu_torch``, as the benchmark calls it.

This is the only module of the harness that imports the program.  It
builds the program's model configuration from a configuration file's
``model`` section, loads the CUDA kernels from the program's build cache
(``ecog2txt_tpu_torch/_build/``, inside the checkout; a library missing
there is compiled by ``nvcc`` first, every source at once), and hands out
the entry points the traffic drives: the trainer's segment runner and the
assessment's greedy decode.
"""

from __future__ import annotations

import concurrent.futures as cf

import torch

import ecog2txt_tpu_torch  # noqa: F401  (fails early in a checkout without the program)
from ecog2txt_tpu_torch.convert import tree_leaves, tree_map
from ecog2txt_tpu_torch.models.conformer import ConformerConfig
from ecog2txt_tpu_torch.models.seq2seq import AuxHead, Seq2SeqConfig, greedy_decode
from ecog2txt_tpu_torch.ops import _build
from ecog2txt_tpu_torch.train import TrainState, make_optimizer, make_segment_runner

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TUPLES = ("conv_sizes", "rnn_sizes", "aux_proj_sizes", "dec_rnn_sizes")


def seq2seq_config(model: dict) -> Seq2SeqConfig:
    """The program's configuration of a configuration file's ``model``."""
    fields = dict(model)
    for key in _TUPLES:
        fields[key] = tuple(fields[key])
    fields["aux_heads"] = tuple(
        AuxHead(h["name"], h["distribution"], int(h["out_dim"])) for h in model["aux_heads"])
    fields["compute_dtype"] = _DTYPES[model["compute_dtype"]]
    if model.get("conformer") is not None:
        fields["conformer"] = ConformerConfig(**model["conformer"])
    return Seq2SeqConfig(**fields)


def load_kernels() -> list[str]:
    """Load every kernel library of ``csrc/`` (building the missing ones
    in parallel); returns their names."""
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    with cf.ThreadPoolExecutor(len(names)) as pool:
        for future in [pool.submit(_build.load_library, n) for n in names]:
            future.result()
    return names


def train_state(weights: dict, learning_rate: float) -> TrainState:
    """The trainer's state over ``weights`` (updated in place): an EMA
    copy and the optimizer, as ``MultiSubjectTrainer`` sets them up."""
    return TrainState(params=weights, ema=tree_map(lambda t: t.detach().clone(), weights),
                      opt_state=make_optimizer(weights, learning_rate), epoch=0)


def segment_runner(config: Seq2SeqConfig, training: dict):
    return make_segment_runner(config, dict(training.get("penalty_scales") or {}),
                               float(training["ema_decay"]))


def first_gradient(state: TrainState) -> list[torch.Tensor]:
    """The clipped gradient the optimizer got at its first step, from its
    state after that step: Adam's first moment is then ``(1 - β1) g``
    (zeros for a leaf the optimizer never stepped)."""
    adam = state.opt_state.adam
    beta1 = adam.param_groups[0]["betas"][0]
    return [adam.state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in adam.state[p]
            else torch.zeros_like(p) for p in tree_leaves(state.params)]


def leaves(tree) -> list[torch.Tensor]:
    return tree_leaves(tree)


def decode(params, config: Seq2SeqConfig, inputs, lengths, generator) -> torch.Tensor:
    """One assessment decode of the partition (greedy, the EMA weights)."""
    with torch.inference_mode():
        return greedy_decode(params, config, inputs, lengths, 0, generator, 0.0)
