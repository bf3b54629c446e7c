"""Per-subject figure factory.

Rebuilds the reference's ``ResultsPlotter`` (reference
plotters.py:122-1510): the electrode-contribution framework (weight
norms / saliency / occlusion sweeps), electrode geometry plots, anatomy
pooling, performance curves, and confusion heatmaps.  Brain-surface 3D
rendering (img_pipe) is out of scope without the lab's electrode ``.mat``
assets; the anatomy interface accepts any {electrode: label} mapping and
degrades to grid coordinates.

All figure functions return the matplotlib ``Figure`` and also save to
``png_partial_path.format(name)`` when configured (reference path
template, mocha-1_word_sequence.yaml:79).

The port's own copy of ``ecog2txt_tpu/plotting/plotters.py``.  The
contribution methods run on the trainer's device: saliency through
``get_saliencies`` (the input gradient: K1f and K1b in a biLSTM),
occlusion through one greedy decode a mask position.  Matplotlib is
imported only where a figure is drawn (``_mpl``).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..assess import wer_vector
from ..geometry import SubgridParams
from ..subjects import ECoGSubject

CONTRIB_METHODS = (
    "weight_norms",
    "saliency_map",
    "occlusion_trained",
    "occlusion_tested",
)


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def anti_alias(sequence: np.ndarray, decimation: int) -> np.ndarray:
    """Low-pass (moving-average FIR) along axis 0 before downsampling —
    the reference anti-aliases saliency sequences
    (plotters.py:534-560)."""
    if decimation <= 1:
        return sequence
    kernel = np.ones(decimation) / decimation
    out = np.apply_along_axis(
        lambda x: np.convolve(x, kernel, mode="same"), 0, sequence
    )
    return out


def _gaussian_kde(
    points: np.ndarray, grid: np.ndarray, bw_adjust: float = 1.0
) -> np.ndarray:
    """Gaussian kernel density of ``points`` evaluated on ``grid``
    (Scott's-rule bandwidth) — the density behind the contribution
    ridgeline (reference plotters.py:1090-1095 uses seaborn's kdeplot;
    no seaborn dependency here)."""
    points = np.asarray(points, float)
    if points.size == 0:
        return np.zeros_like(grid)
    sigma = float(np.std(points))
    bw = bw_adjust * max(
        sigma * points.size ** (-1.0 / 5.0), 1e-3
    )
    z = (grid[:, None] - points[None, :]) / bw
    return np.exp(-0.5 * z**2).sum(axis=1) / (
        points.size * bw * np.sqrt(2 * np.pi)
    )


class ResultsPlotter:
    """One per subject (reference plotters.py:122).

    ``trainer`` is optional: geometry-only figures need just the
    subject; contribution methods need the trained net.
    """

    def __init__(
        self,
        subject: ECoGSubject,
        trainer=None,
        anatomy_labels: dict[int, str] | None = None,
        RGB_color=None,
        VERBOSE: bool = True,
    ):
        self.subject = subject
        self.trainer = trainer
        self._anatomy = anatomy_labels or {}
        self.RGB_color = RGB_color or subject.manifest.resolve(
            "RGB_color", default=(0.2, 0.4, 0.8)
        )
        self.vprint = print if VERBOSE else (lambda *a, **k: None)

    # -- geometry ------------------------------------------------------------

    @property
    def grid(self):
        return self.subject.data_generator.grid

    def electrode_locs_2D(self) -> np.ndarray:
        """(num_channels, 2) (row, col) positions in the layout
        (reference plotters.py:429-440)."""
        pos = self.grid.channel_positions()
        return np.asarray([pos[ch] for ch in self.grid.good_channels], float)

    def anatomy_labels(self) -> list[str]:
        """Per-channel anatomical labels; unknown electrodes map to
        'unknown' (reference pools FreeSurfer labels into grand areas,
        plotters.py:357-426 — the pooling map below mirrors its grand
        list, yaml:anatomy_grand_list)."""
        from .anatomy import anatomy_labels_from_manifest, pool_label

        anatomy = self._anatomy or anatomy_labels_from_manifest(
            self.subject.manifest
        )
        out = []
        m = self.grid.num_electrodes
        for ch in self.grid.good_channels:
            if self.grid.REFERENCE_BIPOLAR:
                elec = self.grid.bipolar_to_elec_map[ch][0]
            else:
                elec = ch % m
            out.append(pool_label(anatomy.get(elec, "unknown")))
        return out

    # -- electrode contributions (reference plotters.py:467-646) -------------

    def elec_contribs(self, contrib_method: str = "weight_norms", **kwargs):
        """Dispatch over contribution methods → (num_channels,) array."""
        if contrib_method not in CONTRIB_METHODS:
            raise ValueError(
                f"unknown contrib_method {contrib_method!r}; "
                f"known {CONTRIB_METHODS}"
            )
        return getattr(self, f"_contribs_{contrib_method}")(**kwargs)

    def _subject_index(self) -> int:
        return self.trainer.ecog_subjects.index(self.subject)

    def _contribs_weight_norms(self) -> np.ndarray:
        """Frobenius norm of the first conv layer per input channel
        (reference plotters.py:508-516).  The conv is stored as a
        (stride·C, E) GEMM kernel; fold the stride taps into the norm."""
        w = self.trainer.get_encoder_embedding(self._subject_index())
        stride = self.trainer.net_config.conv_strides[0]
        C = w.shape[0] // stride
        w = w.reshape(stride, C, w.shape[1])
        norms = np.linalg.norm(w, axis=(0, 2))
        return norms[: self.grid.num_channels]

    def _contribs_saliency_map(
        self, tensor_key: str = "decoder_targets", partition: str = "validation"
    ) -> np.ndarray:
        """Mean |input gradient| per channel, anti-aliased over the
        decimation window (reference plotters.py:534-560)."""
        sal = self.trainer.get_saliencies(tensor_key, partition)
        sal = anti_alias(
            np.abs(sal), self.trainer.net_config.decimation_factor
        )
        return sal.mean(axis=(0, 1))[: self.grid.num_channels]

    def _occlusion_wers(
        self,
        partition: str,
        mask_extent: tuple[int, int] = (2, 2),
        stride: int = 2,
    ) -> tuple[np.ndarray, list[SubgridParams]]:
        """Slide an occlusion subgrid; re-assess WER per position
        (reference plotters.py:567-646).  Returns (WER per position,
        the masks).

        Each position greedy-decodes (beam-searches when ``beam_width`` >
        1) the occluded copy of the partition's real trials with the EMA
        weights, as ``assess`` decodes, one decode a position (each an
        encode through the encoder's kernels).  Every position is
        launched before any result is copied to the host."""
        import torch

        from ..models.beam import beam_decode
        from ..models.seq2seq import greedy_decode
        from ..tokenizers import target_inds_to_sequences

        trainer = self.trainer
        layout = self.grid.layout
        rows, cols = layout.shape
        ds = trainer.packed_dataset(partition)
        dev = trainer.device_data(partition)
        s = self._subject_index()
        n = int(ds.num_trials[s])
        dec_list = self.subject.data_manifests["decoder_targets"].feature_list
        refs = target_inds_to_sequences(ds.decoder_targets[s][:n], dec_list)
        params = trainer.full_params()
        # only the REAL trials (not ragged padding rows)
        inputs, lengths = dev["encoder_inputs"][s][:n], dev["encoder_lengths"][s][:n]
        pending, masks = [], []
        with torch.inference_mode():
            for r0 in range(0, rows - mask_extent[0] + 1, stride):
                for c0 in range(0, cols - mask_extent[1] + 1, stride):
                    sub = SubgridParams(
                        start=(r0, c0), extent=mask_extent, OCCLUDE=True
                    )
                    keep = sub.channel_mask(self.grid).astype(np.float32)
                    keep_padded = np.zeros(
                        trainer.net_config.in_channels, np.float32
                    )
                    keep_padded[: len(keep)] = keep
                    occluded = inputs * torch.from_numpy(keep_padded).to(
                        inputs.device, inputs.dtype
                    )
                    if trainer.beam_width > 1:
                        tokens = beam_decode(
                            params, trainer.net_config, occluded, lengths, s,
                            beam_width=trainer.beam_width,
                            temperature=trainer.temperature,
                        )
                    else:
                        generator = torch.Generator(
                            device=trainer.device
                        ).manual_seed(trainer.seed)
                        tokens = greedy_decode(
                            params, trainer.net_config, occluded, lengths, s,
                            generator, trainer.temperature,
                        )
                    pending.append(tokens)
                    masks.append(sub)
        wers = []
        for tokens_dev in pending:
            hyps = target_inds_to_sequences(
                tokens_dev.cpu().numpy()[:n], dec_list
            )
            wers.append(float(np.mean(wer_vector(refs, hyps))))
        return np.asarray(wers), masks

    def _occlusion_contribs(self, partition: str, **kwargs) -> np.ndarray:
        wers, masks = self._occlusion_wers(partition, **kwargs)
        base = self.trainer.assess([partition])[partition]["word_error_rate"]
        contribs = np.zeros(self.grid.num_channels)
        counts = np.zeros(self.grid.num_channels)
        for wer, sub in zip(wers, masks):
            # channels INSIDE the occluded window get credit for the WER
            # increase their removal caused
            inside = SubgridParams(
                start=sub.start, extent=sub.extent, OCCLUDE=False
            ).channel_mask(self.grid)
            contribs[inside] += wer - base
            counts[inside] += 1
        return contribs / counts.clip(min=1)

    def _contribs_occlusion_trained(self, **kwargs) -> np.ndarray:
        return self._occlusion_contribs("training", **kwargs)

    def _contribs_occlusion_tested(self, **kwargs) -> np.ndarray:
        return self._occlusion_contribs("validation", **kwargs)

    # -- figures --------------------------------------------------------------

    def _save(self, fig, name: str):
        template = self.subject.manifest.resolve("png_partial_path")
        if template:
            path = template.format(name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fig.savefig(path, dpi=150, bbox_inches="tight")
            self.vprint(f"saved {path}")
        return fig

    def plot_elec_contribs_2D(
        self, contrib_method: str = "weight_norms", **kwargs
    ):
        """Contribution scatter on the 2-D grid (reference
        plotters.py:736-882 family)."""
        plt = _mpl()
        contribs = self.elec_contribs(contrib_method, **kwargs)
        locs = self.electrode_locs_2D()
        fig, ax = plt.subplots(figsize=(6, 6))
        sc = ax.scatter(
            locs[:, 1], -locs[:, 0],
            c=contribs, s=120, cmap="viridis", edgecolors="k", linewidths=0.3,
        )
        fig.colorbar(sc, ax=ax, label=contrib_method)
        ax.set_title(
            f"{self.subject.manifest.resolve('subject_name', default=self.subject.subject_id)}"
            f" — {contrib_method}"
        )
        ax.set_aspect("equal")
        return self._save(fig, f"elec_contribs_{contrib_method}")

    def plot_contribs_by_anatomy(
        self, contrib_method: str = "weight_norms", kind: str = "bar", **kwargs
    ):
        """Anatomical-area contribution summary (bar/box/violin —
        reference plotters.py:964-1209)."""
        plt = _mpl()
        contribs = self.elec_contribs(contrib_method, **kwargs)
        labels = self.anatomy_labels()
        areas: dict[str, list[float]] = {}
        for label, value in zip(labels, contribs):
            areas.setdefault(label, []).append(float(value))
        names = sorted(areas)
        fig, ax = plt.subplots(figsize=(7, 4))
        if kind == "bar":
            means = [np.mean(areas[a]) for a in names]
            errs = [
                np.std(areas[a]) / np.sqrt(len(areas[a])) for a in names
            ]
            ax.bar(names, means, yerr=errs, color=self.RGB_color)
        elif kind == "box":
            ax.boxplot([areas[a] for a in names], tick_labels=names)
        elif kind == "violin":
            ax.violinplot([areas[a] for a in names])
            ax.set_xticks(range(1, len(names) + 1), names)
        elif kind == "kde":
            # ridgeline of per-area contribution densities (reference
            # kernel_density_plot_electrode_contributions,
            # plotters.py:1026-1145): one overlapping row per area,
            # Gaussian KDE clipped to [0, 1], electrode scatter at the
            # baseline, area label at the right
            plt.close(fig)
            fig, axes = plt.subplots(
                len(names), 1, figsize=(7, 0.9 * max(len(names), 1)),
                sharex=True, squeeze=False,
            )
            hi = max((max(v) for v in areas.values()), default=1.0) or 1.0
            grid_x = np.linspace(0.0, max(hi, 1e-9), 256)
            for ax_i, name in zip(axes[:, 0], names):
                pts = np.asarray(areas[name], float)
                density = _gaussian_kde(pts / hi, grid_x / hi)
                ax_i.fill_between(
                    grid_x, density, color=self.RGB_color, alpha=0.8, lw=0
                )
                ax_i.plot(grid_x, density, color="w", lw=2)
                ax_i.axhline(0, lw=2, color="k", clip_on=False)
                ax_i.scatter(
                    pts, np.zeros_like(pts), color="black",
                    edgecolors="white", linewidths=1.0, s=80, zorder=3,
                )
                ax_i.text(
                    1.0, 0.1, name, fontweight="bold", ha="right",
                    va="center", transform=ax_i.transAxes,
                )
                ax_i.set_yticks([])
                for side in ("top", "right", "left"):
                    ax_i.spines[side].set_visible(False)
            fig.subplots_adjust(hspace=-0.3)
            axes[-1, 0].set_xlabel("contributions (a.u.)")
            return self._save(fig, f"anatomy_{contrib_method}_{kind}")
        else:
            raise ValueError(f"unknown kind {kind!r}")
        ax.set_ylabel(contrib_method)
        plt.setp(ax.get_xticklabels(), rotation=30, ha="right")
        return self._save(fig, f"anatomy_{contrib_method}_{kind}")

    def bar_plot_ecog_sequence_lengths(self, threshold: float = 0.55):
        """Per-unique-sentence ECoG length bars (mean ± std err) plus
        the WER a length-alone classifier achieves: each validation
        sentence is matched to the training sentence of nearest mean
        length (reference plotters.py:1213-1256).  Returns that WER."""
        plt = _mpl()
        counters = self.subject.count_targets(
            ["training", "validation"], threshold=threshold
        )
        train, val = counters["training"], counters["validation"]
        # synchronize_sequence_counters pads both counters to a common
        # sentence SET but the ORDERS differ and padded clusters carry a
        # meaningless 0.0 mean — so classify only the validation
        # sentences actually observed, against only the training
        # sentences actually observed, and score each prediction
        # against ITS OWN validation sentence
        t_idx = np.flatnonzero(np.asarray(train.counts) > 0)
        v_idx = np.flatnonzero(np.asarray(val.counts) > 0)
        train_means = np.asarray(train.lengths_means)[t_idx]
        val_means = np.asarray(val.lengths_means)[v_idx]
        best_matches = t_idx[
            np.argmin(
                np.abs(val_means[None, :] - train_means[:, None]), axis=0
            )
        ]
        wer = float(
            np.mean(
                wer_vector(
                    [val.unique_sentences[j] for j in v_idx],
                    [train.unique_sentences[i] for i in best_matches],
                )
            )
        )
        fig, ax = plt.subplots(figsize=(8, 3))
        stats = sorted(
            zip(
                train_means,
                np.asarray(train.lengths_std_errs)[t_idx],
            )
        )
        ax.bar(
            range(len(stats)),
            [m for m, _ in stats],
            yerr=[e for _, e in stats],
            width=0.7,
            color=self.RGB_color,
        )
        ax.set_xlabel("sentence ID")
        ax.set_ylabel("length (samples)")
        ax.set_title(f"length-based WER: {100 * wer:.1f}%")
        self._save(fig, "ecog_sequence_lengths")
        return wer

    def bar_plot_nums_examples(
        self,
        datasets_to_plot: Sequence[str] = ("training", "validation"),
        num_sentences_dict: dict[int, int] | None = None,
        ymax: float | None = None,
    ):
        """Stacked example counts per block-type subset: non-unique
        record counts next to unique sentence counts, one bar pair per
        partition (reference plotters.py:1411-1477; the reference
        hard-codes MOCHA's 50-sentence subsets — here
        ``num_sentences_dict`` maps subset id → unique count, default
        the observed unique-sentence count)."""
        from collections import Counter

        from .. import records

        plt = _mpl()
        subset_counters: dict[str, Counter] = {
            p: Counter() for p in datasets_to_plot
        }
        # unique sentences per (partition, subset), collected in the
        # SAME pass as the record counts (one read per block)
        uniques: dict[str, dict[int, set]] = {
            p: {} for p in datasets_to_plot
        }
        manifest = self.subject.data_manifests.get("decoder_targets")
        for partition in datasets_to_plot:
            for block in sorted(self.subject.block_ids(partition)):
                desc = self.subject.block_breakdowns.get(block, {})
                block_type = str(desc.get("type", "0"))
                subset = (
                    int(block_type.rsplit("-", 1)[-1])
                    if block_type.rsplit("-", 1)[-1].isdigit()
                    else 0
                )
                path = self.subject.data_generator.tf_record_path(block)
                seen = uniques[partition].setdefault(subset, set())
                n = 0
                for raw in records.read_examples(path):
                    n += 1
                    if manifest is None:
                        continue
                    value = raw.get(manifest.sequence_type)
                    if value is not None:
                        seen.add(
                            tuple(np.asarray(manifest.parse(value)).ravel())
                        )
                subset_counters[partition][subset] += n
        fig, ax = plt.subplots(figsize=(4, 5))
        subsets = sorted(
            set().union(*(c.keys() for c in subset_counters.values()))
        )
        x = np.arange(2 * len(datasets_to_plot))
        bottom = np.zeros(len(x))
        cmap = _mpl().get_cmap("tab10")
        for subset in subsets:
            non_unique = [
                subset_counters[p][subset] for p in datasets_to_plot
            ]
            if num_sentences_dict is not None:
                n_unique = [
                    num_sentences_dict.get(subset, 0)
                    if subset_counters[p][subset]
                    else 0
                    for p in datasets_to_plot
                ]
            else:
                n_unique = [
                    len(uniques[p].get(subset, ()))
                    for p in datasets_to_plot
                ]
            heights = np.array(non_unique + n_unique, float)
            ax.bar(
                x, heights, bottom=bottom, width=0.7,
                color=cmap(subset % 10), label=f"subset {subset}",
            )
            bottom += heights
        ax.set_xticks(
            x,
            [f"{p}" for p in datasets_to_plot]
            + [f"{p}\n(unique)" for p in datasets_to_plot],
        )
        ax.set_ylabel("num. examples")
        if ymax:
            ax.set_ylim(0, ymax)
        ax.legend(frameon=False, fontsize=8)
        self._save(fig, "nums_examples")
        return {p: dict(c) for p, c in subset_counters.items()}

    def plot_confusions(self, confusions: np.ndarray, class_list=None):
        """Validation confusion heatmap, rebuilt outside any dashboard
        (the reference regenerates these as PDFs because TensorBoard
        renders them badly, trainers.py:604-620).  Skipped ≥100 classes,
        like the reference."""
        if confusions.shape[0] >= 100:
            self.vprint("≥100 classes: skipping confusion heatmap")
            return None
        plt = _mpl()
        row_sums = confusions.sum(axis=1, keepdims=True).clip(min=1)
        fig, ax = plt.subplots(figsize=(7, 6))
        im = ax.imshow(confusions / row_sums, cmap="magma", vmin=0, vmax=1)
        fig.colorbar(im, ax=ax, label="P(pred | true)")
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        if class_list is not None and len(class_list) <= 40:
            ax.set_xticks(range(len(class_list)), class_list, rotation=90,
                          fontsize=6)
            ax.set_yticks(range(len(class_list)), class_list, fontsize=6)
        return self._save(fig, "confusions")

    def plot_performance_vs_training_data(
        self, results: "DecodingResults", metric: str = "word_error_rate"
    ):
        """Per-subject WER vs minutes-of-training curve (reference
        plotters.py:680-734)."""
        plt = _mpl()
        from .results import DecodingResults  # noqa: F401

        minutes = results.nums_seconds.mean_across_folds / 60.0
        matrix = getattr(results, metric)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.errorbar(
            minutes,
            matrix.mean_across_folds,
            yerr=matrix.stderr_across_folds,
            color=self.RGB_color,
            marker="o",
        )
        ax.set_xlabel("training data (min)")
        ax.set_ylabel(metric.replace("_", " "))
        ax.set_ylim(bottom=0)
        return self._save(fig, f"perf_vs_training_{metric}")

    def plot_occlusion_map(self, partition: str = "validation", **kwargs):
        """Spatial map of WER under each occlusion position."""
        plt = _mpl()
        wers, masks = self._occlusion_wers(partition, **kwargs)
        rows, cols = self.grid.layout.shape
        grid = np.full((rows, cols), np.nan)
        for wer, sub in zip(wers, masks):
            r0, c0 = sub.start
            er, ec = sub.extent
            grid[r0 : r0 + er, c0 : c0 + ec] = np.nanmax(
                [grid[r0 : r0 + er, c0 : c0 + ec],
                 np.full((er, ec), wer)], axis=0
            )
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(grid, cmap="coolwarm")
        fig.colorbar(im, ax=ax, label=f"{partition} WER when occluded")
        return self._save(fig, "occlusion_map")


    # -- further reference figures (plotters.py:269-332, 884-962,
    # -- 1259-1405) --------------------------------------------------------

    def plot_activity_animation(
        self,
        ecog: np.ndarray,  # (T, C) one trial
        stride: int = 4,
        interval_ms: int = 50,
    ):
        """Grid-activity animation over a trial (reference
        plotters.py:884-962).  Returns a matplotlib FuncAnimation."""
        plt = _mpl()
        from matplotlib import animation

        rows, cols = self.grid.layout.shape
        positions = self.electrode_locs_2D().astype(int)
        frames = []
        for t in range(0, len(ecog), stride):
            grid = np.full((rows, cols), np.nan)
            for (r, c), value in zip(positions, ecog[t]):
                grid[r, c] = value
            frames.append(grid)
        fig, ax = plt.subplots(figsize=(5, 5))
        vmax = np.nanmax(np.abs(ecog)) or 1.0
        im = ax.imshow(frames[0], cmap="magma", vmin=0, vmax=vmax)
        fig.colorbar(im, ax=ax, label="high-gamma amplitude")

        def update(i):
            im.set_data(frames[i])
            ax.set_title(f"t = {i * stride} samples")
            return (im,)

        anim = animation.FuncAnimation(
            fig, update, frames=len(frames), interval=interval_ms, blit=True
        )
        return anim

    def plot_network_schematic(self, partition: str = "validation"):
        """Schematic figure from the FULL internal-activation probe —
        model-order (reversed) raw inputs, convolved inputs, aligned
        aux target(s), encoder hidden states, and the final state for
        one trial (all the panels of reference plotters.py:1259-1405,
        fed by trainers.py:757-833)."""
        plt = _mpl()
        acts = self.trainer.get_internal_activations(
            partition, self._subject_index()
        )
        trial = 0
        aux_names = list(acts["aux_targets"])
        n_rows = 4 + len(aux_names)
        fig, axes = plt.subplots(
            n_rows, 1, figsize=(8, 2.2 * n_rows), sharex=False
        )
        T_in = int(
            self.trainer.packed_dataset(partition).encoder_lengths[
                self._subject_index(), trial
            ]
        )
        n_enc = int(acts["encoder_lengths"][trial])
        axes[0].imshow(
            acts["model_order_inputs"][trial, :T_in].T,
            aspect="auto", cmap="magma", origin="lower",
        )
        axes[0].set_ylabel("inputs\n(model order)")
        axes[1].imshow(
            acts["convolved_inputs"][trial, :n_enc].T,
            aspect="auto", cmap="magma", origin="lower",
        )
        axes[1].set_ylabel("convolved")
        for i, name in enumerate(aux_names):
            v = acts["aux_targets"][name][trial, :n_enc]
            ax = axes[2 + i]
            if v.ndim == 2:  # Gaussian (MFCC) target heatmap
                ax.imshow(
                    v.T, aspect="auto", cmap="viridis", origin="lower"
                )
            else:  # categorical label track
                ax.step(np.arange(len(v)), v, where="mid")
            ax.set_ylabel(f"target\n{name}")
        axes[-2].imshow(
            acts["encoder_outputs"][trial, :n_enc].T,
            aspect="auto", cmap="coolwarm", origin="lower",
        )
        axes[-2].set_ylabel("encoder units")
        axes[-1].plot(acts["final_state_h"][trial])
        axes[-1].set_ylabel("final state")
        axes[-1].set_xlabel("unit")
        return self._save(fig, "network_schematic")

    def plot_sentence_repeats(
        self, counted: dict[str, int], nominal: int | None = None
    ):
        """Counted vs nominal per-sentence repeats (reference
        plotters.py:269-332)."""
        plt = _mpl()
        names = list(counted)
        values = [counted[n] for n in names]
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.bar(range(len(names)), values, color=self.RGB_color)
        if nominal is not None:
            ax.axhline(nominal, color="k", ls="--", label="nominal")
            ax.legend(frameon=False)
        ax.set_xlabel("sentence")
        ax.set_ylabel("repeats")
        ax.set_xticks([])
        return self._save(fig, "sentence_repeats")

    def electrode_locs_3D(self) -> np.ndarray | None:
        """3-D electrode coordinates from the manifest's electrode file
        (reference plotters.py:443-464); None when unavailable."""
        from .anatomy import electrode_locs_3D

        return electrode_locs_3D(self.subject.manifest)

    def plot_elec_contribs_3D(
        self, contrib_method: str = "weight_norms", **kwargs
    ):
        """3-D scatter on electrode coordinates (reference
        plotters.py:736-882; the img_pipe brain surface itself needs lab
        assets and is omitted)."""
        locs = self.electrode_locs_3D()
        if locs is None:
            self.vprint("no electrode file; falling back to 2D")
            return self.plot_elec_contribs_2D(contrib_method, **kwargs)
        plt = _mpl()
        contribs = self.elec_contribs(contrib_method, **kwargs)
        n = min(len(locs), len(contribs))
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        p = ax.scatter(
            locs[:n, 0], locs[:n, 1], locs[:n, 2],
            c=contribs[:n], cmap="viridis", s=40,
        )
        fig.colorbar(p, ax=ax, label=contrib_method)
        return self._save(fig, f"elec_contribs_3D_{contrib_method}")

    def plot_elec_contribs_on_brain(
        self, contrib_method: str = "weight_norms", **kwargs
    ):
        """Electrode contributions over a cortical surface (the
        reference's img_pipe on-brain rendering, plotters.py:771-795).
        Uses the manifest's ``cortical_mesh_file`` when present
        (npz vertices/faces or a .mat ``cortex`` struct); otherwise a
        generic pial-like ellipsoid fitted to the electrode cloud — a
        degraded but self-contained surface (lab mesh assets are
        non-public).  Requires an elecmatrix (falls back to 2D when
        absent)."""
        locs = self.electrode_locs_3D()
        if locs is None:
            self.vprint("no electrode file; falling back to 2D")
            return self.plot_elec_contribs_2D(contrib_method, **kwargs)
        from .anatomy import generic_pial_mesh, load_cortical_mesh

        mesh = load_cortical_mesh(self.subject.manifest)
        if mesh is None:
            mesh = generic_pial_mesh(locs)
        plt = _mpl()
        contribs = self.elec_contribs(contrib_method, **kwargs)
        n = min(len(locs), len(contribs))
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        v, f = mesh["vertices"], mesh["faces"]
        ax.plot_trisurf(
            v[:, 0], v[:, 1], v[:, 2], triangles=f,
            color=(0.75, 0.75, 0.78), alpha=0.25, linewidth=0,
        )
        p = ax.scatter(
            locs[:n, 0], locs[:n, 1], locs[:n, 2],
            c=contribs[:n], cmap="viridis", s=46, depthshade=False,
        )
        ax.set_axis_off()
        fig.colorbar(p, ax=ax, label=contrib_method, shrink=0.7)
        return self._save(fig, f"elec_contribs_brain_{contrib_method}")


def suffix_to_label(suffix: str, BOLD_LABEL: bool = False) -> str:
    """Experiment-suffix → human figure label, implementing the
    reference's full variant taxonomy (reference plotters.py:1513-1575):
    transfer-learning suffixes carry the donor subject ids after
    ``with`` (``via`` marks the sequential curriculum → "TL", plain
    ``with`` the parallel one → "PTL"), ``mochastar`` marks task/dual
    transfer, and the ablation keywords are ``untargeted`` (no MFCC
    targets), ``undecimated`` (no conv), ``noise`` (length info only),
    ``viterbi`` (phoneme-HMM baseline)."""
    bits = suffix.split("_")

    def donor_ids(after: str) -> list[str]:
        ids = []
        i = bits.index(after) + 1
        while i < len(bits) and bits[i].isdigit():
            ids.append(bits[i])
            i += 1
        return ids

    if "cross-subject" in bits:
        label = " ".join(bits[1:-2])
    elif "via" in bits and "with" in bits:
        ids = ", ".join(donor_ids("with"))
        label = (
            f"+dual TL ({ids})" if "mochastar" in bits
            else f"+subject TL ({ids})"
        )
    elif "with" in bits:
        ids = ", ".join(donor_ids("with"))
        label = (
            f"+dual PTL ({ids})" if "mochastar" in bits
            else f"+subject PTL ({ids})"
        )
    elif "decimated" in bits:
        label = "decimated"
    elif "untargeted" in bits:
        label = "no MFCCs"
    elif "undecimated" in bits:
        label = "no conv."
    elif "lowdensity" in bits:
        label = "low density"
    elif "noise" in bits:
        label = "length info. only"
    elif "mochastar" in bits:
        label = "+task TL"
    elif "viterbi" in bits:
        label = "phoneme-based HMM"
    elif "cross-attention" in bits:
        label = "cross-attention"
    else:
        label = "encoder-decoder"
    if BOLD_LABEL:
        label = rf"{{\bfseries {label}}}"
    return label


def get_save_path(fig_type: str, plotters_list) -> str:
    """Common save path for a figure spanning several plotters
    (reference plotters.py:1930-1940): the common directory prefix of
    every plotter's ``{fig_type}_partial_path`` manifest template, with
    the first plotter's basename."""
    templates = [
        p.subject.manifest.resolve(f"{fig_type}_partial_path")
        for p in plotters_list
    ]
    if any(t is None for t in templates):
        raise ValueError(f"a plotter has no {fig_type}_partial_path")
    common = os.path.commonpath([os.path.dirname(t) for t in templates])
    return os.path.join(common, os.path.basename(templates[0]))
