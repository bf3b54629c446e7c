"""Training orchestration: the segment runner and the MultiSubjectTrainer.

The twin of ``ecog2txt_tpu/train.py`` on the resident path:

* the whole corpus lives on the device (``device_data``; the ECoG inputs
  in bf16 under bf16 compute), and each step gathers
  ``data[subject][idx]`` there from a host-made schedule;
* a training step is ``seq2seq_loss`` with dropout → gradients (through
  the Hopper kernels K1f/K1b when ``use_pallas_lstm`` is True, K4f/K4b
  when it is ``'bi_grid'``) → clip by global
  norm 10 (optax's rule, ``g * 10 / max(|g|, 10)``) → Adam (β 0.9 /
  0.999, eps 1e-8, optax's defaults) → EMA ``d * e + (1 - d) * p``;
* an assessment interval of epochs is one call of the segment runner,
  which returns the segment's mean metrics; assessment greedy-decodes
  (or temperature-samples), or beam-searches when ``beam_width`` > 1
  (``models/beam.py``), with the EMA weights.

Checkpoints are ``convert.save_checkpoint`` files (``ckpt-<epoch>.pt``).
What ``fit`` does beyond the resident path (host-sharded and lazy
streaming, meshes, summaries, scope masks, learning-rate schedules) is
not ported yet: asking for it raises ``NotImplementedError``.  A
non-finite loss raises ``FloatingPointError`` without the JAX trainer's
rollback to a checkpoint.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from . import DATA_PARTITIONS, EOS_token, TOKEN_TYPES, pad_token, resolve_device
from .assess import confusion_matrix, sequence_accuracy, wer_vector
from .config import Manifest, load_experiment_manifest
from .convert import load_checkpoint, save_checkpoint, tree_leaves, tree_map
from .models.beam import beam_decode
from .models.conformer import ConformerConfig
from .models.seq2seq import (
    AuxHead,
    Seq2SeqConfig,
    greedy_decode,
    init_seq2seq,
    seq2seq_loss,
)
from .pipeline import PackedDataset, make_schedule, pack_partition
from .subjects import ECoGSubject
from .tokenizers import (
    read_vocab_file,
    target_inds_to_sequences,
    with_special_tokens,
)

_NOT_PORTED = "is not ported yet (see ROADMAP.md, Queue 1, item 3)"
# SN_kwargs of the JAX trainer that the port does not take yet
_UNPORTED_SN_KWARGS = (
    "distributed", "data_parallel", "sequence_parallel", "pipeline_parallel",
    "tensor_parallel", "expert_parallel", "max_host_trials",
    "max_device_trials", "warmup_steps", "lr_schedule",
)
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLIP_NORM = 10.0  # clip_by_global_norm(10), as the JAX trainer's optimizer


class TrainState(NamedTuple):
    params: Any  # parameter tree of leaf tensors
    ema: Any  # shadow tree, same structure
    opt_state: Any  # torch.optim.Adam over the leaves of params, or None
    epoch: int


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    """Adam over the parameter leaves with optax's defaults."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: ``g * max_norm / max(|g|,
    max_norm)`` with |g| the norm over every leaf (no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))


def make_segment_runner(
    config: Seq2SeqConfig,
    penalty_scales: dict[str, float],
    ema_decay: float,
) -> Callable:
    """Build the multi-step runner.  ``data`` is the stacked (S, N, ...)
    batch dict on the device; the schedule picks (subject, trials) per
    step.  Returns ``run_segment(state, data, subject_per_step (K,),
    indices_per_step (K, B), generator, epochs_in_segment) -> (state,
    mean metrics)``; ``state.params`` and ``state.ema`` are updated in
    place and ``state.opt_state`` steps."""

    def train_step(state: TrainState, data, subject: int, idx, generator):
        batch = {key: value[subject][idx] for key, value in data.items()}
        batch["subject_idx"] = subject
        optimizer = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = seq2seq_loss(
            state.params, config, batch, generator, train=True,
            penalty_scales=penalty_scales,
        )
        loss.backward()
        leaves = tree_leaves(state.params)
        clip_by_global_norm([p.grad for p in leaves], CLIP_NORM)
        optimizer.step()
        with torch.no_grad():
            ema = tree_leaves(state.ema)
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, leaves, alpha=1.0 - ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

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
    run the plain PyTorch versions of the kernels."""

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
        self.device = resolve_device(device)
        self.SN_kwargs = dict(SN_kwargs or {})
        for key in _UNPORTED_SN_KWARGS:
            if self.SN_kwargs.get(key):
                raise NotImplementedError(f"SN_kwargs[{key!r}] {_NOT_PORTED}")
        self.subject_ids = [int(s) for s in subject_ids]
        self._manifest_path = experiment_manifest_name
        self._text_dir = text_dir
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
        self.vprint = print if VERBOSE else (lambda *a, **k: None)

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

        self.set_feature_lists()
        self._build_net()

    # -- manifest-derived properties ---------------------------------------

    @property
    def target_subject(self) -> ECoGSubject:
        return self.ecog_subjects[-1]

    @property
    def manifest(self) -> Manifest:
        return self.manifests[self.subject_ids[-1]]

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
        self.learning_rate = float(
            self.SN_kwargs.get(
                "learning_rate", manifest.resolve("learning_rate", default=1e-3)
            )
        )
        self.batch_size = int(
            self.SN_kwargs.get("batch_size", manifest.resolve("batch_size", default=32))
        )
        params = init_seq2seq(
            self.net_config, torch.Generator().manual_seed(self.seed), self.device
        )
        self.state = TrainState(
            params=params,
            ema=tree_map(lambda t: t.detach().clone(), params),
            opt_state=None,
            epoch=0,
        )
        self._datasets: dict[str, PackedDataset] = {}
        self._device_data: dict[str, dict] = {}
        self.assessments: dict[str, dict] = {}

    # -- data ---------------------------------------------------------------

    def write_tf_records_maybe(self) -> None:
        for subject in self.ecog_subjects:
            subject.write_tf_records_maybe()

    def packed_dataset(self, partition: str, refresh: bool = False) -> PackedDataset:
        if refresh or partition not in self._datasets:
            self.write_tf_records_maybe()
            self._datasets[partition] = pack_partition(
                self.ecog_subjects,
                partition,
                pad_channels_to=self.net_config.in_channels,
                pad_time_multiple=self.net_config.decimation_factor,
            )
            self._device_data.pop(partition, None)
        return self._datasets[partition]

    def device_data(self, partition: str) -> dict:
        """Device-resident copy of a partition's stacked arrays, uploaded
        once and cached.  Under bf16 compute the ECoG inputs are stored
        in bf16 (the model casts them to bf16 at first use anyway); float
        aux targets stay f32, since the regression losses compare
        against them directly."""
        if partition not in self._device_data:
            ds = self.packed_dataset(partition)
            cast = self.net_config.compute_dtype == torch.bfloat16

            def put(k, v):
                t = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                if cast and k == "encoder_inputs" and t.dtype == torch.float32:
                    t = t.to(torch.bfloat16)
                return t

            self._device_data[partition] = {
                k: put(k, v) for k, v in ds.batch_dict().items()
            }
        return self._device_data[partition]

    # -- core fit engine ----------------------------------------------------

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
        keyed by epoch."""
        if train_vars_scope is not None:
            raise NotImplementedError(f"train_vars_scope (scope masks) {_NOT_PORTED}")
        summaries = self.SN_kwargs.get(
            "tf_summaries_dir", self.manifest.resolve("tf_summaries_dir")
        )
        if summaries:
            raise NotImplementedError(f"tf_summaries_dir (summaries) {_NOT_PORTED}")
        if checkpoint_every_assessment is None:
            checkpoint_every_assessment = bool(
                self.SN_kwargs.get("checkpoint_every_assessment", False)
            )
        num_epochs = num_epochs or self.N_epochs
        train_data = self.packed_dataset("training")
        runner = make_segment_runner(
            self.net_config, self.penalty_scales, self.EMA_decay
        )
        if reset_optimizer or self.state.opt_state is None:
            self.state = self.state._replace(
                opt_state=make_optimizer(self.state.params, self.learning_rate)
            )
        data = self.device_data("training")
        rng_np = np.random.default_rng(self.seed + int(self.state.epoch))
        history: dict[str, dict] = {}
        done = 0
        while done < num_epochs:
            segment = min(self.assessment_epoch_interval, num_epochs - done)
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed + 1000 + int(self.state.epoch)
            )
            subjects_sched, idx_sched = make_schedule(
                train_data, self.batch_size, segment, rng_np, subject_subset
            )
            self.state, metrics = runner(
                self.state, data, subjects_sched, idx_sched, generator, segment
            )
            done += segment
            epoch = int(self.state.epoch)
            tm = {k: float(v) for k, v in metrics.items()}
            if not np.isfinite(tm.get("loss_total", 0.0)):
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} "
                    f"(loss={tm['loss_total']}); rolling back to a "
                    f"checkpoint {_NOT_PORTED}. Try a lower learning rate."
                )
            if assess:
                snapshot = self.assess()
                history[str(epoch)] = snapshot
                self.vprint(
                    f"epoch {epoch}: loss {tm['loss_total']:.4f} "
                    f"train WER {snapshot['training']['word_error_rate']:.3f} "
                    f"val WER {snapshot['validation']['word_error_rate']:.3f}"
                )
            if checkpoint_every_assessment:
                self.save_checkpoint(epoch)
        self.assessments = history
        return history

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
        if params is None:
            params = self.state.ema if use_ema else self.state.params
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
        """Write ``{params, ema, epoch}`` for ``epoch`` (default: current)."""
        epoch = int(self.state.epoch) if epoch is None else int(epoch)
        return save_checkpoint(
            self._ckpt_path(epoch), self.state.params, self.state.ema, epoch
        )

    def restore(self, epoch: int | None = None) -> None:
        """Restore (params, EMA, epoch) from the checkpoint at ``epoch``
        (default: newest); the optimizer restarts."""
        epoch = epoch if epoch is not None else self.restore_epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.checkpoint_dir}")
        state = load_checkpoint(self._ckpt_path(epoch), self.device)
        shapes = lambda tree: [tuple(t.shape) for t in tree_leaves(tree)]  # noqa: E731
        if shapes(state["params"]) != shapes(self.state.params):
            raise NotImplementedError(
                "restoring a checkpoint of another architecture "
                f"(update_net_from_saved_model) {_NOT_PORTED}"
            )
        self.state = TrainState(state["params"], state["ema"], None, state["epoch"])

    def assess_saved_model(
        self, restore_epoch: int | None = None, partitions=("validation",)
    ) -> dict:
        """Restore EMA weights from a checkpoint and assess."""
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
        if results_dir is None or not history:
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
