"""Training orchestration: the segment runner and the MultiSubjectTrainer.

The twin of ``ecog2txt_tpu/train.py``, on one device or on the ranks of a
``torch.distributed`` world (``parallel/``):

* the corpus lives on the device (``device_data``; the ECoG inputs in
  bf16 under bf16 compute), and each step gathers ``data[subject][idx]``
  there from a host-made schedule.  ``SN_kwargs`` ``max_device_trials``
  streams it instead in shards of that many trials a subject, and
  ``max_host_trials`` reads the shards lazily from the records
  (``pipeline.LazyShardedDataset``), so that host memory holds a shard,
  not the corpus; a worker thread reads and uploads the next shard while
  the device trains the current one (``pipeline.prefetch``);
* a training step is ``seq2seq_loss`` with dropout → gradients (through
  the Hopper kernels K1f/K1b when ``use_pallas_lstm`` is True, K4f/K4b
  when it is ``'bi_grid'``) → clip by global norm 10 (optax's rule,
  ``g * 10 / max(|g|, 10)``) → Adam (β 0.9 / 0.999, eps 1e-8, optax's
  defaults) at a constant learning rate or optax's warmup schedules
  (``warmup_steps``, ``lr_schedule='warmup_cosine'``) → leaves outside
  ``train_vars_scope`` put back as they were (optax's
  ``masked(set_to_zero)``: they still count in the clip's norm and their
  Adam moments still advance) → EMA ``d * e + (1 - d) * p`` over every
  leaf;
* an assessment interval of epochs is one call of the segment runner,
  which returns the segment's mean metrics; assessment greedy-decodes
  (or temperature-samples), or beam-searches when ``beam_width`` > 1
  (``models/beam.py``), with the EMA weights; ``tf_summaries_dir``
  writes the curves as TensorBoard scalars (``utils/summaries.py``).

Checkpoints are ``convert.save_checkpoint`` files (``ckpt-<epoch>.pt``),
written synchronously.  A non-finite segment loss restores the newest
checkpoint, then raises ``FloatingPointError``.  ``restore`` rebuilds the
net from a checkpoint of another architecture (``utils/introspect.py``),
and ``import_tf1_checkpoint`` reads the reference's TF1 checkpoints
(``utils/tf1_import.py``).  ``sequential_transfer_learn`` is the
reference's subject-by-subject curriculum.

The parallel modes, one process a device: ``SN_kwargs['distributed'] =
{'coordinator_address', 'num_processes', 'process_id'}`` (or the
environment ``torchrun`` sets) wires the ranks before anything else;
``data_parallel`` (each rank a slice of every batch), ``sequence_parallel
= K`` (the conformer's time axis over K ranks), ``expert_parallel = K``
(the MoE experts over K ranks), ``tensor_parallel = K`` (the wide
weights' columns over K ranks) and ``pipeline_parallel = S`` (the
conformer's blocks in S stages, ``pipeline_microbatches`` a batch) build
the JAX trainer's meshes (``parallel/mesh.py``): ``(data, model[, seq])``,
or ``(data[, seq], pp[, model])`` with a pipeline.  They compose as the
JAX trainer's do (dp×sp, dp×ep, ep×sp, dp×tp, tp×sp, dp×pp, sp×pp, ep×pp,
ep×sp×pp, tp×pp, tp×sp×pp); tp×ep is refused.  Each rank holds its part
of every leaf (tp columns, experts, a stage's blocks), with its EMA and
Adam moments, and computes its share of the global loss; the gradients
are summed over the ranks that hold the same part and clipped by the
global norm (a split leaf's squares summed over the axes that split it),
so every rank takes the one-process step on the same global batch.  The
ranks stay in lockstep: the metrics (hence the NaN rollback's decision)
are global, rank 0 writes the records, the vocab, the checkpoints (every
part gathered: the one-process format) and the results while the others
wait, and every rank assesses the same EMA weights.

The analysis layer hangs off the trainer as in the JAX package:
``results_plotter`` (``plotting.ResultsPlotter``: electrode
contributions by weight norms, saliency and occlusion, and the figures),
``cluster_embedded_words`` (``plotting.embeddings``; needs sklearn) and
the sweeps of ``experiments.py``.  ``torch_learn`` is ``fit`` under the
JAX trainer's name for its PyTorch engine: here the trainer is that
engine.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import re
import warnings
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import DATA_PARTITIONS, EOS_token, TOKEN_TYPES, pad_token, resolve_device
from .assess import confusion_matrix, sequence_accuracy, wer_vector
from .config import Manifest, load_experiment_manifest
from .convert import load_checkpoint, save_checkpoint, tree_leaves, tree_map
from .models.beam import beam_decode
from .models.conformer import ConformerConfig
from .models.seq2seq import (
    AuxHead,
    Seq2SeqConfig,
    _decimate_targets,
    convolve_sequences,
    encode,
    greedy_decode,
    init_seq2seq,
    seq2seq_loss,
)
from .ops.lstm import reverse_padded
from .parallel.mesh import (  # noqa: F401
    Placement,
    clip_by_global_norm,
    make_dp_train_step,
    make_mesh,
    parallel_modes,
    replicate,
)
from .parallel.pipeline import check_microbatches
from .parallel.multihost import initialize_distributed, initialize_from_environment, rank_device
from .pipeline import (
    _PREFETCH_END,
    LazyShardedDataset,
    PackedDataset,
    make_schedule,
    pack_partition,
    prefetch,
    restrict_trials,
    shard_dataset,
)
from .records import read_examples
from .subjects import ECoGSubject
from .tokenizers import (
    read_vocab_file,
    target_inds_to_sequences,
    with_special_tokens,
)
from .utils import tf1_import
from .utils.introspect import _shape_tree, recover_model_sizes
from .utils.summaries import SummaryWriter

# the SN_kwargs that ask for a mesh
_PARALLEL_SN_KWARGS = ("data_parallel", "sequence_parallel", "expert_parallel",
                       "tensor_parallel", "pipeline_parallel")
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLIP_NORM = 10.0  # clip_by_global_norm(10), as the JAX trainer's optimizer


class TrainState(NamedTuple):
    params: Any  # parameter tree of leaf tensors
    ema: Any  # shadow tree, same structure
    opt_state: Any  # torch.optim.Adam over the leaves of params, or None
    epoch: int


def lr_schedule(
    learning_rate: float,
    warmup_steps: int = 0,
    total_steps: int | None = None,
    kind: str | None = None,
) -> Callable[[int], float] | None:
    """The learning rate of the optimizer's update number ``count`` (from
    0), as ``_make_optimizer`` of the JAX trainer schedules it; None for a
    constant rate.  With ``warmup_steps`` and ``total_steps``:
    ``kind='warmup_cosine'`` is ``optax.warmup_cosine_decay_schedule(0, lr,
    warmup, max(total, warmup + 1))`` (the decay steps include the warmup;
    the rate reaches 0 at their end), anything else
    ``optax.linear_schedule(0, lr, warmup)``.  Both give the first update
    rate 0."""
    warmup = int(warmup_steps or 0)
    if not (warmup and total_steps):
        return None

    def linear(count: int) -> float:
        frac = 1.0 - min(max(count, 0), warmup) / warmup
        return (0.0 - learning_rate) * frac + learning_rate

    if kind != "warmup_cosine":
        return linear
    decay = max(int(total_steps), warmup + 1) - warmup

    def warmup_cosine(count: int) -> float:
        if count < warmup:
            return linear(count)
        t = min(count - warmup, decay)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return warmup_cosine


class Optimizer:
    """optax's ``chain(clip_by_global_norm(10), adam(lr),
    masked(set_to_zero(), frozen))`` over the leaves of a parameter tree,
    on ``torch.optim.Adam`` with optax's defaults.

    ``schedule`` (``lr_schedule``) gives each update's rate from the
    update count, which starts at 0 with the optimizer; None keeps
    ``learning_rate``.  ``trainable`` is a tree of bools of the
    parameters' structure (``MultiSubjectTrainer._scope_mask``), None for
    all: a frozen leaf is put back bit for bit after each Adam step, so
    that, as under optax's mask, it still counts in the clip's global norm
    and its moments still advance.  ``learning_rates`` holds the rate of
    every update taken."""

    def __init__(self, params, learning_rate: float, schedule=None, trainable=None):
        self.leaves = tree_leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.adam = torch.optim.Adam(
            self.leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        self.learning_rate = learning_rate
        self.learning_rates: list[float] = []  # one an update: its count
        self.set_rule(schedule, trainable)

    def set_rule(self, schedule=None, trainable=None) -> None:
        """Replace the schedule and the trainable mask (the Adam state and
        the updates taken stay)."""
        self.schedule = schedule
        flags = [True] * len(self.leaves) if trainable is None else tree_leaves(trainable)
        if len(flags) != len(self.leaves):
            raise ValueError(
                f"trainable mask has {len(flags)} leaves; the parameters {len(self.leaves)}"
            )
        self.frozen = [p for p, keep in zip(self.leaves, flags) if not keep]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.adam.zero_grad(set_to_none=set_to_none)

    def step(self) -> float:
        """One Adam update at the rate of its count; returns the rate."""
        count = len(self.learning_rates)
        lr = self.learning_rate if self.schedule is None else self.schedule(count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        with torch.no_grad():
            kept = [p.detach().clone() for p in self.frozen]
            self.adam.step()
            if kept:
                torch._foreach_copy_(self.frozen, kept)
        self.learning_rates.append(lr)
        return lr


def make_optimizer(
    params, learning_rate: float, schedule=None, trainable=None
) -> Optimizer:
    """:class:`Optimizer` over the parameter leaves (requires_grad on)."""
    return Optimizer(params, learning_rate, schedule, trainable)


def make_segment_runner(
    config: Seq2SeqConfig,
    penalty_scales: dict[str, float],
    ema_decay: float,
    mesh=None,
    modes: dict | None = None,
    split: list | None = None,
) -> Callable:
    """Build the multi-step runner.  ``data`` is the stacked (S, N, ...)
    batch dict on the device; the schedule picks (subject, trials) per
    step.  Returns ``run_segment(state, data, subject_per_step (K,),
    indices_per_step (K, B), generator, epochs_in_segment) -> (state,
    mean metrics)``; ``state.params`` and ``state.ema`` are updated in
    place and ``state.opt_state`` steps.

    A step is ``parallel.mesh.make_dp_train_step``'s (clip 10, Adam, EMA).
    On a ``mesh`` every rank holds the same data and schedule; the step
    takes this rank's slice of the batch over the ``data`` axis (the whole
    batch when B does not divide by it: each rank's loss is then 1/n of
    the batch's), the loss share of ``seq2seq_loss`` under its parallel
    keywords ``modes`` (default: ``parallel.mesh.parallel_modes(mesh)``;
    the trainer passes ``Placement.modes``), and sums the gradients over
    the ranks that hold each leaf before the clip (``split``: the axes each
    leaf is split over, ``parallel.mesh.Placement.split``); the metrics
    are the global batch's.  Under ``pp`` a batch must split into the
    microbatches, and each microbatch over the data ranks (``ValueError``,
    as JAX raises)."""
    if modes is None:
        modes = parallel_modes(mesh) if mesh is not None else {}
    pp = modes.get("pp")
    step = make_dp_train_step(
        lambda params, batch, generator: seq2seq_loss(
            params, config, batch, generator, train=True,
            penalty_scales=penalty_scales, **modes,
        ),
        ema_decay, mesh, clip_norm=CLIP_NORM, split=split,
    )

    def train_step(state: TrainState, data, subject: int, idx, generator):
        if pp is not None:
            check_microbatches(len(idx), pp[2], mesh.shape["data"])
        batch = {key: value[subject][idx] for key, value in data.items()}
        batch["subject_idx"] = subject
        return step(state.params, state.ema, state.opt_state, batch, generator)[1]

    def run_segment(
        state: TrainState,
        data: dict,
        subject_per_step,
        indices_per_step,
        generator: torch.Generator,
        epochs_in_segment: int,
    ):
        device = tree_leaves(state.params)[0].device
        idx = torch.as_tensor(
            np.asarray(indices_per_step), dtype=torch.long
        ).to(device)
        history: dict[str, list] = {}
        for k, subject in enumerate(np.asarray(subject_per_step).tolist()):
            metrics = train_step(state, data, int(subject), idx[k], generator)
            for name, value in metrics.items():
                history.setdefault(name, []).append(value)
        means = {k: torch.stack(v).float().mean() for k, v in history.items()}
        return state._replace(epoch=state.epoch + epochs_in_segment), means

    return run_segment


# --------------------------------------------------------------------------
# trainer
# --------------------------------------------------------------------------


class MultiSubjectTrainer:
    """Main user-facing API object, on the port's resident path.

    The LAST subject id is the target subject; all earlier ids are
    transfer donors trained with ``pretrain_all_blocks``.  ``device``
    defaults to CUDA and raises without a GPU; pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels.  Under
    ``torch.distributed`` (``SN_kwargs['distributed']`` or ``torchrun``)
    ``'cuda'`` is the card of the rank's ``LOCAL_RANK`` (modulo the
    host's cards), and the parallel ``SN_kwargs`` build ``self.mesh``."""

    def __init__(
        self,
        experiment_manifest_name: str,
        subject_ids: Sequence[int],
        text_dir: str | None = None,
        SN_kwargs: dict | None = None,
        DG_kwargs: dict | None = None,
        ES_kwargs: dict | None = None,
        RP_kwargs: dict | None = None,
        VERBOSE: bool = True,
        seed: int = 0,
        device="cuda",
        **kwargs: Any,
    ):
        self.SN_kwargs = dict(SN_kwargs or {})
        device = resolve_device(device)
        # the multi-process bootstrap, before anything else: the
        # 'distributed' key, else the environment torchrun sets when a
        # parallel mode is asked for
        if self.SN_kwargs.get("distributed"):
            initialize_distributed(**{"device": device, **self.SN_kwargs["distributed"]})
        elif any(self.SN_kwargs.get(k) for k in _PARALLEL_SN_KWARGS):
            initialize_from_environment(device)
        self.device = rank_device(device)
        self.subject_ids = [int(s) for s in subject_ids]
        self._manifest_path = experiment_manifest_name
        self._text_dir = text_dir
        self._trial_subset: dict[int, Any] = {}
        self.manifests = load_experiment_manifest(
            experiment_manifest_name, text_dir
        )
        self.DG_kwargs = dict(DG_kwargs or {})
        if text_dir is not None:
            self.DG_kwargs.setdefault("text_dir", text_dir)
        self.ES_kwargs = dict(ES_kwargs or {})
        self.RP_kwargs = dict(RP_kwargs or {})
        self.kwargs = kwargs
        self.VERBOSE = VERBOSE
        self.seed = seed
        self.vprint = print if VERBOSE and _is_writer() else (lambda *a, **k: None)

        manifest = self.manifests[self.subject_ids[-1]]
        token_type = manifest.resolve("token_type", default="word_sequence")
        if token_type not in TOKEN_TYPES:
            raise ValueError(f"unrecognized token_type {token_type!r}")
        self.token_type = token_type
        self.TARGETS_ARE_SEQUENCES = token_type.endswith("sequence")

        self.ecog_subjects = [
            ECoGSubject(
                self.manifests[sid],
                sid,
                pretrain_all_blocks=(sid != self.subject_ids[-1]),
                DG_kwargs=self.DG_kwargs,
                **self.ES_kwargs,
            )
            for sid in self.subject_ids
        ]
        for subject in self.ecog_subjects:
            if self.TARGETS_ARE_SEQUENCES:
                subject.set_append_eos("decoder_targets", True)

        # rank 0 writes the records and the induced vocab; the other ranks
        # wait for it, then read them
        if not _is_writer():
            dist.barrier()
        self.set_feature_lists()
        if _is_writer() and _world_size() > 1:
            self.write_tf_records_maybe()
            dist.barrier()
        self._build_net()

    # -- manifest-derived properties ---------------------------------------

    @property
    def target_subject(self) -> ECoGSubject:
        return self.ecog_subjects[-1]

    @property
    def manifest(self) -> Manifest:
        return self.manifests[self.subject_ids[-1]]

    @property
    def results_plotter(self):
        """Lazily-constructed per-target-subject plotter (reference
        trainers.py:259-275); assign to replace."""
        if getattr(self, "_results_plotter", None) is None:
            from .plotting import ResultsPlotter

            self._results_plotter = ResultsPlotter(
                self.target_subject, self, VERBOSE=self.VERBOSE
            )
        return self._results_plotter

    @results_plotter.setter
    def results_plotter(self, plotter) -> None:
        self._results_plotter = plotter

    @property
    def checkpoint_dir(self) -> str:
        path = self.manifest.resolve(
            "checkpoint_dir",
            self.SN_kwargs.get("checkpoint_dir"),
            os.path.join(
                self.manifest.resolve("saved_results_dir", default="."),
                "checkpoints",
            ),
        )
        os.makedirs(path, exist_ok=True)
        return path

    # -- vocab resolution ----------------------------------------------------

    def set_feature_lists(self) -> None:
        """4-level resolution per categorical sequence type:
        (1) explicit ``<seq_type>_vocab_list`` kwarg →
        (2) vocab file → (3) pickled list in checkpoint_dir →
        (4) induced training-∩ / validation-∪ across subjects."""
        from . import text_dir as default_text_dir

        mapping = self.target_subject.data_mapping
        for tensor_key, seq_type in mapping.items():
            manifest0 = self.target_subject.data_manifests[tensor_key]
            if not manifest0.is_categorical:
                continue
            class_list = self.kwargs.get(f"{seq_type}_vocab_list")
            if class_list is None:
                vocab_file = self.manifest.resolve(f"{seq_type}_vocab_file")
                if vocab_file is not None:
                    candidates = (
                        [vocab_file]
                        if os.path.isabs(vocab_file)
                        else [
                            os.path.join(d, vocab_file)
                            for d in (self._text_dir, default_text_dir)
                            if d
                        ]
                    )
                    for path in candidates:
                        if os.path.exists(path):
                            class_list = read_vocab_file(path)
                            break
            pkl = os.path.join(self.checkpoint_dir, f"{seq_type}_vocab_file.pkl")
            if class_list is None and os.path.exists(pkl):
                with open(pkl, "rb") as f:
                    class_list = pickle.load(f)
            if class_list is None:
                class_list = self._training_intersection_validation_union(
                    seq_type
                )
                if _is_writer():
                    with open(pkl, "wb") as f:
                        pickle.dump(class_list, f)
            class_list = with_special_tokens(
                class_list, self.TARGETS_ARE_SEQUENCES
            )
            for subject in self.ecog_subjects:
                subject.set_feature_list(tensor_key, class_list)

    def _training_intersection_validation_union(
        self, sequence_type: str
    ) -> list[str]:
        """Induced vocab: per-partition reduce over subjects (∩ for
        training, ∪ otherwise), then ∪ over partitions, order-preserving."""
        per_partition: dict[str, list[str]] = {}
        for partition in DATA_PARTITIONS:
            lists = [
                subject.data_generator.write_to_Protobuf_maybe(
                    sequence_type, sorted(subject.block_ids(partition))
                )
                for subject in self.ecog_subjects
            ]
            if not lists:
                per_partition[partition] = []
            elif partition == "training":
                keep = set(lists[0])
                for tokens in lists[1:]:
                    keep &= set(tokens)
                per_partition[partition] = [t for t in lists[0] if t in keep]
            else:
                merged: dict[str, None] = {}
                for tokens in lists:
                    for t in tokens:
                        merged.setdefault(t)
                per_partition[partition] = list(merged)
        out: dict[str, None] = {}
        for partition in DATA_PARTITIONS:
            for t in per_partition[partition]:
                out.setdefault(t)
        return list(out)

    # -- net construction ---------------------------------------------------

    def _build_net(self) -> None:
        manifest = self.manifest
        layer_sizes = dict(manifest.resolve("layer_sizes", default={}))
        layer_sizes.update(self.SN_kwargs.get("layer_sizes") or {})
        target_manifests = self.target_subject.data_manifests

        aux_heads = []
        self.penalty_scales: dict[str, float] = {}
        for tensor_key, dm in target_manifests.items():
            if tensor_key in ("encoder_inputs", "decoder_targets"):
                self.penalty_scales.setdefault(tensor_key, dm.penalty_scale)
                continue
            if dm.distribution == "CTC":
                aux_heads.append(AuxHead(tensor_key, "CTC", dm.num_features + 1))
            else:
                aux_heads.append(
                    AuxHead(
                        tensor_key,
                        "categorical" if dm.is_categorical else dm.distribution,
                        dm.num_features,
                    )
                )
            self.penalty_scales[tensor_key] = dm.penalty_scale

        in_channels = max(
            s.data_generator.num_ECoG_channels for s in self.ecog_subjects
        )
        dec_list = target_manifests["decoder_targets"].feature_list
        TEMPORALLY_CONVOLVE = bool(
            manifest.resolve(
                "TEMPORALLY_CONVOLVE",
                self.SN_kwargs.get("TEMPORALLY_CONVOLVE"),
                True,
            )
        )
        conv_sizes = (
            tuple(layer_sizes.get("encoder_embedding", [100]))
            if TEMPORALLY_CONVOLVE
            else ()
        )
        dtype_name = str(self.SN_kwargs.get("compute_dtype", "float32"))
        if dtype_name not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {dtype_name!r}: expected one of "
                f"{sorted(_COMPUTE_DTYPES)}"
            )
        # conformer hyperparameters: manifest key 'conformer' or
        # SN_kwargs['conformer'], a dict of ConformerConfig fields; None
        # keeps the defaults of models/conformer.py
        conformer_kwargs = manifest.resolve(
            "conformer", self.SN_kwargs.get("conformer"), None
        )
        self.net_config = Seq2SeqConfig(
            vocab_size=len(dec_list),
            num_subjects=len(self.ecog_subjects),
            in_channels=in_channels,
            conv_sizes=conv_sizes,
            decimation_factor=self.target_subject.decimation_factor,
            rnn_sizes=tuple(layer_sizes.get("encoder_rnn", [400] * 3)),
            aux_proj_sizes=tuple(layer_sizes.get("encoder_1_projection", [225])),
            aux_heads=tuple(aux_heads),
            dec_embedding_size=layer_sizes.get("decoder_embedding", [150])[0],
            dec_rnn_sizes=tuple(layer_sizes.get("decoder_rnn", [800])),
            max_dec_len=int(
                self.SN_kwargs.get(
                    "max_dec_len",
                    manifest.resolve(
                        "max_dec_len",
                        default=20 if self.TARGETS_ARE_SEQUENCES else 1,
                    ),
                )
            ),
            FF_dropout=float(manifest.resolve("FF_dropout", default=0.1)),
            RNN_dropout=float(manifest.resolve("RNN_dropout", default=0.5)),
            temperature=float(manifest.resolve("temperature", default=0.0)),
            use_attention=bool(
                manifest.resolve(
                    "cross_attention", self.SN_kwargs.get("use_attention"), False
                )
            ),
            encoder_type=str(
                manifest.resolve(
                    "encoder_type", self.SN_kwargs.get("encoder_type"), "lstm"
                )
            ),
            conformer=(
                ConformerConfig(**conformer_kwargs) if conformer_kwargs else None
            ),
            use_pallas_lstm=self.SN_kwargs.get("use_pallas_lstm", False),
            compute_dtype=_COMPUTE_DTYPES[dtype_name],
            pad_id=int(dec_list.index(pad_token)),
            eos_id=(
                int(dec_list.index(EOS_token)) if EOS_token in dec_list else -1
            ),
        )
        self.beam_width = int(
            self.SN_kwargs.get("beam_width", manifest.resolve("beam_width", default=1))
        )
        self.N_epochs = int(
            self.SN_kwargs.get("N_epochs", manifest.resolve("N_epochs", default=200))
        )
        self.EMA_decay = float(manifest.resolve("EMA_decay", default=0.99))
        self.assessment_epoch_interval = int(
            manifest.resolve("assessment_epoch_interval", default=10)
        )
        self._summary_writer = None
        self.learning_rate = float(
            self.SN_kwargs.get(
                "learning_rate", manifest.resolve("learning_rate", default=1e-3)
            )
        )
        self.batch_size = int(
            self.SN_kwargs.get("batch_size", manifest.resolve("batch_size", default=32))
        )
        self._make_mesh()
        self._init_state()
        self.assessments: dict[str, dict] = {}

    def _make_mesh(self) -> None:
        """The mesh of the parallel ``SN_kwargs``, as the JAX trainer builds
        it, with its checks: ``sequence_parallel`` and ``pipeline_parallel``
        need the conformer, ``tensor_parallel`` × ``expert_parallel`` is
        refused (both split weights over ``model``), ``expert_parallel``
        needs a MoE conformer whose experts it divides.  Without a pipeline
        the mesh is ``(data, model[, seq])``; with one ``(data[, seq], pp[,
        model])``, ``pipeline_microbatches`` (default: the stages) a batch.
        ``data_parallel`` takes the ranks the other axes leave.  Sets
        ``self.mesh`` (None in a one-process run) and what the ``model``
        axis splits; ``_init_state`` places the parameters and sets the
        loss's parallel keywords, ``self.sp``, ``self.ep``, ``self.tp`` and
        ``self.pp`` (``parallel.mesh.parallel_modes``)."""
        self.mesh = self._split_by = None
        n_seq, n_pp, n_tp, n_ep = (int(self.SN_kwargs.get(k) or 0) for k in (
            "sequence_parallel", "pipeline_parallel", "tensor_parallel", "expert_parallel"))
        conformer = self.net_config.encoder_type == "conformer"
        if n_seq > 1 and not conformer:
            raise ValueError(
                "sequence_parallel requires encoder_type='conformer' "
                "(the biLSTM recurrence cannot shard over time)"
            )
        if n_pp > 1 and not conformer:
            raise ValueError("pipeline_parallel requires encoder_type='conformer'")
        if n_tp > 1 and n_ep > 1:
            raise ValueError(
                "tensor_parallel × expert_parallel is not supported: "
                "both shard weight matrices over the 'model' axis "
                "(expert leaves on their expert dim, wide kernels on "
                "their output dim)"
            )
        if n_ep > 1:
            ccfg = self.net_config.conformer
            if not (conformer and ccfg and ccfg.moe_experts):
                raise ValueError(
                    "expert_parallel requires a MoE conformer "
                    "(SN_kwargs conformer={'moe_experts': E, ...})"
                )
            if ccfg.moe_experts % n_ep:
                raise ValueError(
                    f"expert_parallel={n_ep} must divide evenly into "
                    f"moe_experts={ccfg.moe_experts}"
                )
        n_seq, n_pp, n_tp, n_ep = (max(n, 1) for n in (n_seq, n_pp, n_tp, n_ep))
        n_model = max(n_tp, n_ep)
        wants_dp = bool(self.SN_kwargs.get("data_parallel"))
        if not (wants_dp or n_seq * n_pp * n_model > 1):
            return
        if not dist.is_initialized() and n_seq * n_pp * n_model == 1:
            return  # data_parallel in a one-process run: the one-process path
        n_data = max(_world_size() // (n_model * n_seq * n_pp), 1) if wants_dp else 1
        self.mesh = make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq, n_pp=n_pp)
        self._split_by = "ep" if n_ep > 1 else "tp" if n_tp > 1 else None

    def _init_state(self) -> None:
        """Fresh parameters for ``net_config`` from the trainer's seed, and
        empty data caches; on a mesh, the first rank's parameters on every
        rank, cut to each rank's placement (``_place``), and the loss's
        parallel keywords."""
        params = init_seq2seq(
            self.net_config, torch.Generator().manual_seed(self.seed), self.device
        )
        self._placement, self._modes = None, {}
        if self.mesh is not None:
            replicate(params, self.mesh)
            self._placement = Placement(
                self.mesh, params, tp=self._split_by == "tp", pp="pp" in self.mesh.shape,
                experts=self.net_config.conformer.moe_experts if self._split_by == "ep" else 0)
            self._modes = self._placement.modes(
                int(self.SN_kwargs.get("pipeline_microbatches") or 0) or None)
        self.sp, self.ep, self.tp, self.pp = (self._modes.get(k) for k in ("sp", "ep", "tp", "pp"))
        params = self._place(params)
        self.state = TrainState(
            params=params,
            ema=tree_map(lambda t: t.detach().clone(), params),
            opt_state=None,
            epoch=0,
        )
        self._datasets: dict[str, PackedDataset] = {}
        self._device_data: dict[str, dict] = {}

    # -- placement on the mesh -------------------------------------------------

    def _place(self, tree):
        """This rank's placement of a whole parameter tree (the JAX
        trainer's ``_place_state``; ``parallel.mesh.Placement``): the wide
        leaves' columns under ``tensor_parallel``, the experts under
        ``expert_parallel``, the blocks of the rank's stage under
        ``pipeline_parallel``; the tree itself in one process."""
        return self._placement.place(tree) if self._placement is not None else tree

    def full_params(self, use_ema: bool = True, tree=None):
        """The whole parameter tree (EMA by default, or ``tree``): the
        inverse of ``_place``, gathered from the ranks that hold its parts
        (a collective: every rank calls it), else the tree itself."""
        if tree is None:
            tree = self.state.ema if use_ema else self.state.params
        return self._placement.gather(tree) if self._placement is not None else tree

    def _rank_seed(self, seed: int) -> int:
        """A seed for this rank's dropout: the data ranks draw their own
        masks, the ranks that share a slice of the batch the same."""
        if self.mesh is None or self.mesh.shape["data"] == 1:
            return seed
        return _fold_in(seed, 7919 + self.mesh.coord("data"))

    # -- data ---------------------------------------------------------------

    def write_tf_records_maybe(self) -> None:
        for subject in self.ecog_subjects:
            subject.write_tf_records_maybe()

    def packed_dataset(self, partition: str, refresh: bool = False) -> PackedDataset:
        if refresh or partition not in self._datasets:
            self.write_tf_records_maybe()
            ds = pack_partition(
                self.ecog_subjects,
                partition,
                pad_channels_to=self.net_config.in_channels,
                pad_time_multiple=self.net_config.decimation_factor,
            )
            if partition == "training":
                for s, indices in self._trial_subset.items():
                    ds = restrict_trials(ds, s, indices)
            self._datasets[partition] = ds
            self._device_data.pop(partition, None)
        return self._datasets[partition]

    def device_data(self, partition: str) -> dict:
        """Device-resident copy of a partition's stacked arrays, uploaded
        once and cached.  Under bf16 compute the ECoG inputs are stored
        in bf16 (the model casts them to bf16 at first use anyway); float
        aux targets stay f32, since the regression losses compare
        against them directly."""
        if partition not in self._device_data:
            self._device_data[partition] = self._upload(
                self.packed_dataset(partition).batch_dict()
            )
        return self._device_data[partition]

    def _upload(self, arrays: dict) -> dict:
        """Host arrays → tensors on the device, ``encoder_inputs`` in bf16
        under bf16 compute."""
        cast = self.net_config.compute_dtype == torch.bfloat16

        def put(k, v):
            t = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            if cast and k == "encoder_inputs" and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            return t

        return {k: put(k, v) for k, v in arrays.items()}

    def restricted_to_trials(
        self, indices, subject_index: int = -1
    ) -> "MultiSubjectTrainer":
        """Fresh trainer (parameters from the seed) whose TRAINING set is
        restricted to the given trial indices of one subject: the retrain
        unit of the perf-vs-training-size sweep."""
        clone = MultiSubjectTrainer(
            self._manifest_path,
            self.subject_ids,
            text_dir=self._text_dir,
            SN_kwargs=self.SN_kwargs,
            DG_kwargs=self.DG_kwargs,
            ES_kwargs=self.ES_kwargs,
            RP_kwargs=self.RP_kwargs,
            VERBOSE=False,
            seed=self.seed,
            device=self.device,
            **self.kwargs,  # explicit *_vocab_list kwargs survive
        )
        s = subject_index if subject_index >= 0 else len(self.ecog_subjects) + subject_index
        clone._trial_subset = {s: list(indices)}
        return clone

    # -- optimizers / scope masks ------------------------------------------

    def _scope_mask(self, train_vars_scope: str | None):
        """Trainability mask (a tree of bools of the parameters' structure)
        from a scope regex matched at the start of ``"seq2seq/"`` + the
        slash-joined leaf path ('seq2seq/subnet/conv/0/w',
        'seq2seq/encoder/rnn/0/fwd/wx', ...): the reference's regexes
        ``seq2seq/subnet`` and ``seq2seq/(?!subnet)`` work verbatim.  None
        for no scope."""
        if train_vars_scope is None:
            return None
        pattern = re.compile(train_vars_scope)
        # a pipeline stage's blocks keep their place in the whole stack
        first_block = 0
        if getattr(self, "pp", None) is not None:
            first_block = self.mesh.coord("pp") * (
                self.net_config.conformer.num_blocks // self.mesh.shape["pp"])

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + [str(k)]) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                base = first_block if path == ["encoder", "conformer", "blocks"] else 0
                return [walk(v, path + [str(base + i)]) for i, v in enumerate(node)]
            return bool(pattern.match("seq2seq/" + "/".join(path)))

        return walk(self.state.params, [])

    def _lr_schedule(self, total_steps: int):
        """``SN_kwargs`` ``warmup_steps`` / ``lr_schedule`` over a fit of
        ``total_steps`` updates (``lr_schedule``)."""
        return lr_schedule(
            self.learning_rate,
            int(self.SN_kwargs.get("warmup_steps", 0)),
            total_steps,
            self.SN_kwargs.get("lr_schedule"),
        )

    # -- core fit engine ----------------------------------------------------

    @property
    def summary_writer(self):
        """TensorBoard scalars for the training curves (``tf_summaries_dir``:
        SN_kwargs over the manifest; an explicit ``None`` in SN_kwargs
        disables summaries even when the manifest names a directory).  The
        event file is created on first access; a directory that cannot be
        made warns once and disables summaries instead of failing the run."""
        if self._summary_writer is None:
            if "tf_summaries_dir" in self.SN_kwargs:
                logdir = self.SN_kwargs["tf_summaries_dir"]
            else:
                logdir = self.manifest.resolve("tf_summaries_dir", default=None)
            if not logdir:
                self._summary_writer = False
            else:
                try:
                    self._summary_writer = SummaryWriter(str(logdir))
                except OSError as err:
                    warnings.warn(
                        f"tf_summaries_dir {logdir!r} unusable ({err}); summaries disabled"
                    )
                    self._summary_writer = False
        return self._summary_writer or None

    def fit(
        self,
        subject_subset: Sequence[int] | None = None,
        num_epochs: int | None = None,
        train_vars_scope: str | None = None,
        reset_optimizer: bool = True,
        assess: bool = True,
        checkpoint_every_assessment: bool | None = None,
    ) -> dict[str, dict]:
        """Train for ``num_epochs``, assessing every
        ``assessment_epoch_interval``.  Returns the assessments history
        keyed by epoch.

        ``train_vars_scope`` trains only the leaves it matches
        (``_scope_mask``).  ``checkpoint_every_assessment`` (default: the
        SN_kwargs key of that name) saves a checkpoint after each
        interval.  A non-finite segment loss restores the newest
        checkpoint and raises ``FloatingPointError``."""
        if checkpoint_every_assessment is None:
            checkpoint_every_assessment = bool(
                self.SN_kwargs.get("checkpoint_every_assessment", False)
            )
        num_epochs = num_epochs or self.N_epochs
        self.write_tf_records_maybe()
        # the lazy host pipeline (max_host_trials): shards of that many
        # trials (or of max_device_trials, if smaller) re-read from the
        # records on demand; the corpus never sits whole in host memory
        max_host = self.SN_kwargs.get("max_host_trials")
        max_dev = self.SN_kwargs.get("max_device_trials")
        lazy_shards = None
        if max_host:
            lazy_shards = LazyShardedDataset(
                self.ecog_subjects,
                "training",
                min(int(max_host), int(max_dev or max_host)),
                pad_channels_to=self.net_config.in_channels,
                pad_time_multiple=self.net_config.decimation_factor,
                trial_subset=self._trial_subset or None,
            )
            train_counts = lazy_shards.num_trials
        else:
            train_data = self.packed_dataset("training")
            train_counts = train_data.num_trials
        # the schedule's length counts every subject's steps, under
        # subject_subset too, as the JAX trainer does
        steps_per_epoch = sum(-(-int(n) // self.batch_size) for n in train_counts if n > 0)
        total_steps = num_epochs * max(steps_per_epoch, 1)
        schedule = self._lr_schedule(total_steps)
        trainable = self._scope_mask(train_vars_scope)
        if reset_optimizer or self.state.opt_state is None:
            optimizer = make_optimizer(
                self.state.params, self.learning_rate, schedule, trainable
            )
            self.state = self.state._replace(opt_state=optimizer)
        else:
            self.state.opt_state.set_rule(schedule, trainable)
        runner = make_segment_runner(
            self.net_config, self.penalty_scales, self.EMA_decay, self.mesh, self._modes,
            self._placement.split(self.state.params) if self._placement is not None else None,
        )
        # host-sharded streaming when the corpus exceeds the device budget
        # (max_device_trials): each shard trains `segment` epochs in turn
        streaming = lazy_shards is not None or (
            bool(max_dev) and train_data.encoder_inputs.shape[1] > int(max_dev)
        )
        if streaming:
            shards = lazy_shards if lazy_shards is not None else shard_dataset(
                train_data, int(max_dev)
            )
        else:
            data = self.device_data("training")
        rng_np = np.random.default_rng(self.seed + int(self.state.epoch))
        history: dict[str, dict] = {}
        done = 0
        try:
            while done < num_epochs:
                segment = min(self.assessment_epoch_interval, num_epochs - done)
                seed = self._rank_seed(self.seed + 1000 + int(self.state.epoch))
                if streaming:
                    for si, (subjects_sched, idx_sched), shard_dev in prefetch(
                        self._shard_producer(shards, segment, rng_np, subject_subset)
                    ):
                        generator = torch.Generator(device=self.device).manual_seed(
                            _fold_in(seed, si)
                        )
                        self.state, metrics = runner(
                            self.state, shard_dev, subjects_sched, idx_sched,
                            generator, 0,  # epochs counted once, below
                        )
                    self.state = self.state._replace(epoch=self.state.epoch + segment)
                else:
                    generator = torch.Generator(device=self.device).manual_seed(seed)
                    subjects_sched, idx_sched = make_schedule(
                        train_data, self.batch_size, segment, rng_np, subject_subset
                    )
                    self.state, metrics = runner(
                        self.state, data, subjects_sched, idx_sched, generator, segment
                    )
                done += segment
                epoch = int(self.state.epoch)
                tm = {k: float(v) for k, v in metrics.items()}
                # a diverged segment is rolled back to the newest checkpoint
                # before it surfaces, so the state is never left non-finite
                if not np.isfinite(tm.get("loss_total", 0.0)):
                    recovered = ""
                    if self.restore_epoch is not None:
                        self.restore()
                        recovered = (
                            f"; restored checkpoint at epoch {int(self.state.epoch)}"
                        )
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch} "
                        f"(loss={tm['loss_total']}){recovered}. Try a lower "
                        "learning rate or warmup_steps."
                    )
                writer = self.summary_writer if _is_writer() else None
                if writer is not None:
                    writer.scalars(
                        {
                            (f"loss/{k[5:]}" if k.startswith("loss_") else f"train/{k}"): v
                            for k, v in tm.items()
                        },
                        epoch,
                    )
                if assess:
                    snapshot = self.assess()
                    history[str(epoch)] = snapshot
                    self.vprint(
                        f"epoch {epoch}: loss {tm['loss_total']:.4f} "
                        f"train WER {snapshot['training']['word_error_rate']:.3f} "
                        f"val WER {snapshot['validation']['word_error_rate']:.3f}"
                    )
                    if writer is not None:
                        writer.scalars(
                            {
                                f"{part}/{key}": snap[key]
                                for part, snap in snapshot.items()
                                for key in ("accuracy", "word_error_rate")
                            },
                            epoch,
                        )
                if writer is not None:
                    writer.flush()
                if checkpoint_every_assessment:
                    self.save_checkpoint(epoch)
        finally:
            if lazy_shards is not None:
                lazy_shards.close()
        self.assessments = history
        return history

    def _shard_producer(self, shards, segment: int, rng_np, subject_subset):
        """``produce`` for ``pipeline.prefetch``: each call takes the next
        shard with trials of the scheduled subjects, draws its schedule
        (the draws stay in shard order) and uploads it; on a CUDA device
        the upload runs on a stream of its own, which the worker waits
        for.  Returns ``(si, schedule, tensors)`` or ``_PREFETCH_END``."""
        shard_iter = enumerate(shards)
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def produce():
            for si, shard in shard_iter:
                counts = shard.num_trials
                if subject_subset is not None:
                    counts = counts[list(subject_subset)]
                if not int(counts.sum()):
                    continue
                sched = make_schedule(
                    shard, self.batch_size, segment, rng_np, subject_subset
                )
                if stream is None:
                    return si, sched, self._upload(shard.batch_dict())
                with torch.cuda.stream(stream):
                    tensors = self._upload(shard.batch_dict())
                stream.synchronize()
                return si, sched, _on_current_stream(tensors)
            return _PREFETCH_END

        return produce

    # -- assessment ---------------------------------------------------------

    @property
    def temperature(self) -> float:
        """Assessment-decode temperature: SN_kwargs override > manifest >
        0 (greedy)."""
        return float(self.SN_kwargs.get("temperature", self.net_config.temperature))

    def assess(
        self,
        partitions: Sequence[str] = ("training", "validation"),
        use_ema: bool = True,
        params: Any = None,
    ) -> dict[str, dict]:
        """Greedy-decode (temperature-sample when ``temperature`` > 0; beam
        search when ``beam_width`` > 1) each partition with the (EMA)
        weights; returns per-partition WER /
        accuracy / confusions.  Every decode is launched before any
        result is copied to the host."""
        params = self.full_params(use_ema, params)
        dec_list = self.target_subject.data_manifests["decoder_targets"].feature_list
        pending: dict[str, list] = {p: [] for p in partitions}
        with torch.inference_mode():
            for partition in partitions:
                ds = self.packed_dataset(partition)
                dev = self.device_data(partition)
                for s in range(ds.num_subjects):
                    n = int(ds.num_trials[s])
                    if n == 0:
                        continue
                    # deterministic per-(partition, subject) sampling
                    generator = torch.Generator(device=self.device).manual_seed(
                        self.seed * 7919 + s * 7
                        + list(DATA_PARTITIONS).index(partition)
                    )
                    inputs, lengths = dev["encoder_inputs"][s], dev["encoder_lengths"][s]
                    if self.beam_width > 1:
                        tokens = beam_decode(
                            params, self.net_config, inputs, lengths, s,
                            beam_width=self.beam_width, temperature=self.temperature,
                        )
                    else:
                        tokens = greedy_decode(
                            params, self.net_config, inputs, lengths, s, generator,
                            self.temperature,
                        )
                    pending[partition].append((s, n, tokens))
        out: dict[str, dict] = {}
        for partition in partitions:
            ds = self.packed_dataset(partition)
            all_refs, all_hyps = [], []
            true_ids, pred_ids = [], []
            for s, n, tokens_dev in pending[partition]:
                tokens = tokens_dev.cpu().numpy()[:n]
                hyps = target_inds_to_sequences(tokens, dec_list)
                refs = target_inds_to_sequences(ds.decoder_targets[s][:n], dec_list)
                all_refs += refs
                all_hyps += hyps
                L = min(tokens.shape[1], ds.decoder_targets.shape[2])
                true_ids.append(ds.decoder_targets[s][:n, :L])
                pred_ids.append(tokens[:, :L])
            wers = wer_vector(all_refs, all_hyps)
            out[partition] = {
                "word_error_rate": float(np.mean(wers)) if len(wers) else 1.0,
                "word_error_rates": wers,
                "accuracy": sequence_accuracy(all_refs, all_hyps),
                "decoder_confusions": confusion_matrix(
                    np.concatenate(true_ids) if true_ids else np.zeros((0, 1)),
                    np.concatenate(pred_ids) if pred_ids else np.zeros((0, 1)),
                    len(dec_list),
                ),
                "references": all_refs,
                "hypotheses": all_hyps,
            }
        return out

    # -- training entry points ----------------------------------------------

    def parallel_transfer_learn(self, RESUME: bool = False, **fit_kwargs) -> dict:
        """Joint training of all subjects in one runner.  RESUME restricts
        to the target subject, from the latest checkpoint."""
        if RESUME:
            epoch = self.restore_epoch
            if epoch is not None:
                self.restore(epoch)
            history = self.fit(
                subject_subset=[len(self.ecog_subjects) - 1], **fit_kwargs
            )
        else:
            history = self.fit(**fit_kwargs)
        self._save_results(history)
        self.save_checkpoint()
        return history

    def torch_learn(
        self,
        N_epochs: int | None = None,
        device=None,
        push_weights: bool = True,
        **ST_kwargs,
    ) -> dict:
        """The JAX trainer's second engine (reference trainers.py:278-301,
        PyTorch ``SequenceTrainer.train_and_assess``): train this
        trainer's model for ``N_epochs`` (default ``N_epochs``) from its
        current weights, assessing every ``assessment_epoch_interval``,
        and return the history in ``fit``'s format.

        In the port the trainer is that PyTorch engine, so this is
        ``fit`` (``ST_kwargs`` are ``fit``'s keywords) and the JAX
        package's ``torch_engine.py`` has no copy here.  ``device=None``
        means the trainer's device; any other device must be it, or this
        raises ``ValueError``.  ``push_weights`` is accepted for the JAX
        signature: the weights trained are the trainer's already."""
        if device is not None and not _same_device(device, self.device):
            raise ValueError(
                f"torch_learn: device {str(device)!r} is not the trainer's "
                f"({str(self.device)!r}); build the trainer on that device"
            )
        history = self.fit(num_epochs=N_epochs or self.N_epochs, **ST_kwargs)
        self._save_results(history)
        return history

    def sequential_transfer_learn(
        self,
        pretraining: int = 60,
        training: int = 200,
        posttraining: int = 340,
    ) -> dict:
        """The reference's subject-by-subject curriculum: subject 0 trains
        ``training`` epochs; each later subject first fits only the subnets
        (``seq2seq/subnet``) against the frozen shared core on its own
        batches for ``pretraining`` epochs, unassessed, then everything on
        the subjects so far; the target subject gets ``training +
        posttraining`` epochs."""
        history: dict = {}
        for i in range(len(self.ecog_subjects)):
            is_last = i == len(self.ecog_subjects) - 1
            if i > 0:
                self.fit(
                    subject_subset=[i],
                    num_epochs=pretraining,
                    train_vars_scope=r"seq2seq/subnet",
                    assess=False,
                )
            epochs = training + (posttraining if is_last else 0)
            history = self.fit(subject_subset=list(range(i + 1)), num_epochs=epochs)
        self._save_results(history)
        self.save_checkpoint()
        return history

    # -- checkpoints ----------------------------------------------------------

    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.checkpoint_dir, f"ckpt-{epoch}.pt")

    @property
    def restore_epoch(self) -> int | None:
        """Latest checkpointed epoch under ``checkpoint_dir``."""
        epochs = [
            int(m.group(1))
            for name in os.listdir(self.checkpoint_dir)
            if (m := re.fullmatch(r"ckpt-(\d+)\.pt", name))
        ]
        return max(epochs) if epochs else None

    def save_checkpoint(self, epoch: int | None = None) -> str:
        """Write ``{params, ema, epoch}`` for ``epoch`` (default: current).
        On a mesh rank 0 writes the whole trees (the experts gathered: the
        one-process format, which ``restore`` reads at any world size) and
        every rank returns after the file is complete."""
        epoch = int(self.state.epoch) if epoch is None else int(epoch)
        params, ema = self.full_params(tree=self.state.params), self.full_params()
        path = self._ckpt_path(epoch)
        if _is_writer():
            save_checkpoint(path, params, ema, epoch)
        if _world_size() > 1:
            dist.barrier()
        return path

    def restore(self, epoch: int | None = None) -> None:
        """Restore (params, EMA, epoch) from the checkpoint at ``epoch``
        (default: newest); the optimizer restarts.  A checkpoint of another
        architecture first rebuilds ``net_config`` from its tensor shapes
        (``update_net_from_saved_model``), so any saved model can be
        assessed whatever ``layer_sizes`` the trainer was built with."""
        epoch = epoch if epoch is not None else self.restore_epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.checkpoint_dir}")
        state = load_checkpoint(self._ckpt_path(epoch), self.device)
        if _shape_tree(state["params"]) != _shape_tree(self.full_params(tree=self.state.params)):
            self.vprint(
                "checkpoint architecture differs from the constructed net; "
                "rebuilding hyperparameters from tensor shapes"
            )
            self.update_net_from_saved_model(state["params"])
        self.state = TrainState(self._place(state["params"]), self._place(state["ema"]), None,
                                state["epoch"])

    def import_tf1_checkpoint(self, ckpt_path, rebuild="auto") -> dict[str, list[str]]:
        """Import weights (and EMA shadows) from a reference TF1
        ``model.ckpt-<epoch>``, or from a ``{name: array}`` mapping of its
        variables, into the live state (``utils/tf1_import.py``).  Reading a
        file needs tensorflow; a mapping does not.

        ``rebuild``: ``'auto'`` rebuilds ``net_config`` from the
        checkpoint's tensor shapes first when they disagree with the
        constructed architecture, ``True`` whenever the checkpoint is
        complete, ``False`` never (a mismatch raises).  The optimizer
        restarts.  Returns the imported / skipped variable names."""
        variables = (
            tf1_import.read_tf1_checkpoint(ckpt_path)
            if isinstance(ckpt_path, str)
            else dict(ckpt_path)
        )
        if rebuild:
            sizes = tf1_import.recover_model_sizes(variables)
            ls = sizes["layer_sizes"]
            cfg = self.net_config
            # only a complete checkpoint (all three stacks) defines an
            # architecture; a partial mapping imports into the constructed one
            complete = bool(ls["encoder_embedding"] and ls["encoder_rnn"] and ls["decoder_rnn"])
            mismatch = complete and (
                tuple(ls["encoder_rnn"]) != cfg.rnn_sizes
                or tuple(ls["encoder_embedding"]) != cfg.conv_sizes
                or tuple(ls["decoder_rnn"]) != cfg.dec_rnn_sizes
                or sizes.get("vocab_size", cfg.vocab_size) != cfg.vocab_size
            )
            if (rebuild is True and complete) or mismatch:
                self.vprint(
                    "TF1 checkpoint architecture differs from the constructed "
                    "net; rebuilding from tensor shapes"
                )
                self._apply_recovered_sizes(sizes)
        params, ema, report = tf1_import.import_tf1_checkpoint(
            variables, self.full_params(tree=self.state.params), self.full_params(),
            subject_ids=self.subject_ids,
        )
        self.state = self.state._replace(params=self._place(params), ema=self._place(ema),
                                         opt_state=None)
        self.vprint(
            f"TF1 import: {len(report['imported'])} variables imported, "
            f"{len(report['skipped'])} skipped"
        )
        return report

    def update_net_from_saved_model(self, source) -> None:
        """Rebuild ``net_config`` from checkpoint tensor shapes; ``source``
        is a parameter tree or a ``ckpt-<epoch>.pt`` path.  Every field that
        ``recover_model_sizes`` infers (conv sizes, LSTM sizes, aux and
        projection dims, vocab, attention, directionality, the conformer's
        blocks and widths) replaces the constructed value."""
        self._apply_recovered_sizes(
            recover_model_sizes(source, in_channels=self.net_config.in_channels)
        )

    def _apply_recovered_sizes(self, sizes: dict) -> None:
        """Apply a recovered-architecture dict (``utils.introspect`` or
        ``utils.tf1_import`` ``recover_model_sizes``) to ``net_config`` and
        re-initialize the state and the data caches for it."""
        cfg = self.net_config
        layer_sizes = sizes["layer_sizes"]
        aux_dims = sizes.get("aux_heads", {})
        aux_heads = tuple(
            head._replace(out_dim=aux_dims.get(head.name, head.out_dim))
            for head in cfg.aux_heads
            if head.name in aux_dims
        ) or cfg.aux_heads
        new_cfg = dataclasses.replace(
            cfg,
            vocab_size=int(sizes.get("vocab_size", cfg.vocab_size)),
            in_channels=int(sizes.get("in_channels", cfg.in_channels)),
            num_subjects=int(sizes.get("num_subjects", cfg.num_subjects)),
            conv_sizes=tuple(layer_sizes["encoder_embedding"]),
            decimation_factor=int(sizes.get("decimation_factor", cfg.decimation_factor)),
            rnn_sizes=tuple(layer_sizes["encoder_rnn"]),
            aux_proj_sizes=tuple(layer_sizes["encoder_1_projection"]) or cfg.aux_proj_sizes,
            aux_heads=aux_heads,
            dec_embedding_size=int(
                layer_sizes["decoder_embedding"][0]
                if layer_sizes.get("decoder_embedding")
                else cfg.dec_embedding_size
            ),
            dec_rnn_sizes=tuple(layer_sizes["decoder_rnn"]),
            use_attention=bool(sizes.get("use_attention", cfg.use_attention)),
            BIDIRECTIONAL=bool(sizes.get("BIDIRECTIONAL", cfg.BIDIRECTIONAL)),
        )
        if sizes.get("encoder_type") == "lstm" and cfg.encoder_type != "lstm":
            new_cfg = dataclasses.replace(new_cfg, encoder_type="lstm")
        if sizes.get("encoder_type") == "conformer":
            # blocks, widths, kernel and MoE width come from the shapes;
            # heads, chunk and left context leave no trace in them and carry
            # over from the constructed config
            base = cfg.conformer or ConformerConfig()
            new_cfg = dataclasses.replace(
                new_cfg,
                encoder_type="conformer",
                conformer=dataclasses.replace(base, **sizes["conformer"]),
                # a conformer checkpoint has no encoder rnn stack: keep the
                # constructed sizes rather than ()
                rnn_sizes=cfg.rnn_sizes,
            )
        if new_cfg.vocab_size != cfg.vocab_size:
            self.vprint(
                f"warning: checkpoint vocab size {new_cfg.vocab_size} != "
                f"constructed {cfg.vocab_size}; decode indices follow the checkpoint"
            )
        self.net_config = new_cfg
        # a template state of the recovered architecture; the caller
        # overwrites its values from the checkpoint
        self._init_state()

    def assess_saved_model(
        self, restore_epoch: int | None = None, partitions=("validation",)
    ) -> dict:
        """Restore EMA weights from a checkpoint (rebuilding the net from
        its shapes if the architectures differ) and assess."""
        self.restore(restore_epoch)
        return self.assess(partitions=partitions, use_ema=True)

    # -- results files --------------------------------------------------------

    def _results_file_name(self) -> str:
        project = self.manifest.resolve("project", default="proj")
        ids = "_".join(str(s) for s in self.subject_ids)
        ff = self.net_config.FF_dropout
        rnn = self.net_config.RNN_dropout
        sizes = "-".join(
            str(s)
            for s in (
                list(self.net_config.conv_sizes)
                + list(self.net_config.rnn_sizes)
                + list(self.net_config.dec_rnn_sizes)
            )
        )
        return f"accuracies_{project}{ids}_{ff}_{rnn}_{sizes}"

    def _save_results(self, history: dict[str, dict]) -> str | None:
        results_dir = self.manifest.resolve("saved_results_dir")
        if results_dir is None or not history or not _is_writer():
            return None
        os.makedirs(results_dir, exist_ok=True)
        path = os.path.join(results_dir, self._results_file_name())
        with open(path, "w") as f:
            for epoch, snap in history.items():
                tr, va = snap["training"], snap["validation"]
                f.write(
                    f"{tr['accuracy']:.6f} {tr['word_error_rate']:.6f} "
                    f"{va['accuracy']:.6f} {va['word_error_rate']:.6f} "
                    f"{epoch}\n"
                )
        return path

    # -- inspection utilities ------------------------------------------------

    def subject_to_table(self):
        """Per-subject overview table (a pandas DataFrame; pandas is
        imported here, and only here)."""
        import pandas as pd

        rows = []
        for subject in self.ecog_subjects:
            dm = subject.data_manifests
            rows.append(
                {
                    "subject": subject.subject_id,
                    "channels": subject.data_generator.num_ECoG_channels,
                    "decimation": subject.decimation_factor,
                    "training_blocks": sorted(subject.block_ids("training")),
                    "validation_blocks": sorted(subject.block_ids("validation")),
                    "vocab_size": dm["decoder_targets"].num_features,
                }
            )
        return pd.DataFrame(rows).set_index("subject")

    def count_all_targets(self) -> dict[int, dict]:
        return {
            subject.subject_id: subject.count_targets() for subject in self.ecog_subjects
        }

    def print_tensor_names(self) -> list[str]:
        """Parameter paths (``seq2seq/...``) and shapes, one a leaf."""
        names = []
        for path, shape in _shape_tree(self.full_params(tree=self.state.params)).items():
            names.append(f"seq2seq/{path} {shape}")
            self.vprint(names[-1])
        return names

    def tf_record_to_numpy_data(self, subject_index: int = -1, block=None):
        """Raw-record inspection generator: every example of a subject's
        blocks (or of one block) as parsed arrays."""
        subject = self.ecog_subjects[subject_index]
        blocks = [block] if block is not None else sorted(subject.all_blocks)
        for b in blocks:
            yield from read_examples(subject.data_generator.tf_record_path(b))

    # -- analysis hooks ------------------------------------------------------

    def get_saliencies(
        self,
        tensor_key: str = "decoder_targets",
        partition: str = "validation",
        use_ema: bool = True,
    ) -> np.ndarray:
        """Input-gradient saliency for one loss head: every other penalty
        scale zeroed, ``torch.autograd.grad`` of the loss (``train=False``)
        with respect to the inputs; (N, T, C) over the partition's trials,
        subject by subject."""
        scales = {k: 0.0 for k in self.penalty_scales}
        scales[tensor_key] = 1.0
        params = tree_map(lambda t: t.detach(), self.full_params(use_ema))
        ds = self.packed_dataset(partition)
        grads = []
        for s in range(ds.num_subjects):
            n = int(ds.num_trials[s])
            batch = {
                k: torch.from_numpy(np.ascontiguousarray(v[s])).to(self.device)
                for k, v in ds.batch_dict().items()
            }
            batch["subject_idx"] = s
            inputs = batch["encoder_inputs"].requires_grad_(True)
            loss, _ = seq2seq_loss(
                params, self.net_config, batch, train=False, penalty_scales=scales
            )
            (grad,) = torch.autograd.grad(loss, inputs)
            grads.append(grad.float().cpu().numpy()[:n])
        return np.concatenate(grads, axis=0)

    def get_weights_as_numpy_array(self, name: str, use_ema: bool = True) -> np.ndarray:
        """One parameter by slash path (e.g. 'decoder/embedding',
        'encoder/rnn/0/fwd/wh')."""
        node: Any = self.full_params(use_ema)
        for part in name.split("/"):
            node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
        return node.detach().float().cpu().numpy()

    def cluster_embedded_words(
        self, method: str = "pca", num_clusters: int = 8, plot: bool = True
    ):
        """Cluster the decoder word-embedding rows (reference
        trainers.py:677-679 → plotters cluster_embeddings); needs
        sklearn."""
        from .plotting.embeddings import cluster_embeddings

        embeddings = self.get_weights_as_numpy_array("decoder/embedding")
        class_list = self.target_subject.data_manifests["decoder_targets"].feature_list
        return cluster_embeddings(
            embeddings,
            class_list=class_list,
            method=method,
            num_clusters=num_clusters,
            plot=plot,
        )

    def get_encoder_embedding(
        self, subject_index: int = -1, use_ema: bool = True
    ) -> np.ndarray:
        """First conv layer's weights for one subject: the
        electrode-contribution basis."""
        params = self.state.ema if use_ema else self.state.params
        return params["subnet"]["conv"][0]["w"][subject_index].detach().float().cpu().numpy()

    def get_internal_activations(
        self, partition: str = "validation", subject_index: int = -1
    ) -> dict[str, np.ndarray]:
        """Forward-pass intermediates of the EMA weights for one subject's
        trials of a partition (batch-major, real trials only):
        ``model_order_inputs`` (N, T, C), the raw inputs in the order the
        encoder reads them (valid prefix reversed for the biLSTM, natural
        time for the conformer); ``convolved_inputs`` (N, T', F), the
        subnet conv stack's output; ``aux_targets`` {head: (N, T'[, F])},
        each head's targets aligned to encoder steps as the loss aligns
        them (CTC heads have no alignment and are left out); and
        ``encoder_outputs``, ``final_state_h`` / ``_c`` and
        ``encoder_lengths``."""
        config = self.net_config
        ds = self.packed_dataset(partition)
        s = subject_index if subject_index >= 0 else ds.num_subjects + subject_index
        n = int(ds.num_trials[s])
        host = lambda t: t.float().cpu().numpy()  # noqa: E731
        with torch.inference_mode():
            inputs = torch.from_numpy(np.ascontiguousarray(ds.encoder_inputs[s])).to(self.device)
            lengths = torch.from_numpy(np.ascontiguousarray(ds.encoder_lengths[s])).to(self.device)
            ema = self.full_params()
            enc_out, final, enc_lengths = encode(ema, config, inputs, lengths, s, train=False)
            reverse = config.encoder_type != "conformer"
            xs = inputs.transpose(0, 1)  # (T, B, C)
            model_order = reverse_padded(xs, lengths) if reverse else xs
            if config.conv_sizes:
                convolved = convolve_sequences(
                    ema, config, xs, s, None, train=False,
                    reverse_lengths=lengths if reverse else None,
                )  # (T', B, F)
            else:
                d0 = config.decimation_factor
                convolved = model_order[: (xs.shape[0] // d0) * d0 : d0]
            T_out = convolved.shape[0]
            aux_aligned: dict[str, np.ndarray] = {}
            for head in config.aux_heads:
                raw = ds.aux_targets.get(head.name)
                if head.distribution == "CTC" or raw is None:
                    continue
                ts = torch.from_numpy(np.ascontiguousarray(raw[s])).to(self.device)
                aligned = _decimate_targets(
                    ts.transpose(0, 1), lengths, config.decimation_factor, T_out,
                    reverse=reverse,
                )
                aux_aligned[head.name] = np.moveaxis(aligned.cpu().numpy(), 0, 1)[:n]
            return {
                "model_order_inputs": np.moveaxis(host(model_order), 0, 1)[:n],
                "convolved_inputs": np.moveaxis(host(convolved), 0, 1)[:n],
                "aux_targets": aux_aligned,
                "encoder_outputs": np.moveaxis(host(enc_out), 0, 1)[:n],
                "final_state_h": host(final[0])[:n],
                "final_state_c": host(final[1])[:n],
                "encoder_lengths": enc_lengths.cpu().numpy()[:n],
            }


def _same_device(a, b) -> bool:
    """Whether two device names are one device (``'cuda'`` is the
    current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _is_writer() -> bool:
    """Whether this process writes the files a run shares (records, vocab,
    checkpoints, results, summaries): rank 0, or a one-process run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _fold_in(seed: int, i: int) -> int:
    """A seed for item ``i`` of a stream seeded ``seed`` (JAX's
    ``fold_in``'s role): deterministic in both, well mixed."""
    return int(np.random.SeedSequence((int(seed), int(i))).generate_state(1, np.uint64)[0] >> 1)


def _on_current_stream(tensors: dict) -> dict:
    """Mark tensors made on a side stream as used on the current stream, so
    that the caching allocator does not hand their memory out again before
    the current stream's work on them is done."""
    stream = torch.cuda.current_stream()
    for t in tensors.values():
        t.record_stream(stream)
    return tensors
