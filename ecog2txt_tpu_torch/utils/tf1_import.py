"""TF1 checkpoint weight import (migration tool).

The reference trains with TF1 and saves ``model.ckpt-<epoch>`` files
whose variable-scope grammar is fully documented by its own
shape-recovery walk (reference trainers.py:444-554) and weight readout
(plotters.py:684-701):

* ``seq2seq/`` outer scope; per-subject layers under ``subnet_<id>/``.
* Feed-forward layers: ``<scope>_<in>_<out>_<layer>/weights`` (+
  ``biases``), e.g. ``encoder_embedding_225_100_0/weights``.  The conv
  ("embedding") weights are 4-D ``(1, stride, in, out)``
  (trainers.py:536-541); the FINAL layer of every ``*_projection``
  scope is stored TRANSPOSED, ``(out, in)`` (trainers.py:519-524).
* RNN layers: any scope containing ``cell_<n>`` (trainers.py:481-487).
  The encoder's biLSTM layers are numbered on the SCOPE
  (``encoder_rnn_<l>``, trainers.py:546-553) with fw/bw sub-scopes;
  the decoder's cells are numbered ``cell_<l>``.  TF1 LSTM kernels
  pack ``[x; h] → 4H`` in one ``(in+H, 4H)`` matrix with gate order
  (i, g, f, o) — the SAME order this repo uses (ops/lstm.py) — and add
  ``forget_bias`` at runtime exactly like our ``+1`` constant, so
  kernels split row-wise into (wx, wh) and biases map verbatim.
* EMA shadows: ``<var>/ExponentialMovingAverage`` (trainers.py:467).

``import_tf1_checkpoint`` maps those variables onto an
``init_seq2seq`` parameter tree of the port (and its EMA twin): each
imported leaf is a torch tensor on the old leaf's device, in its dtype.
``tf1_variables_from_params`` is the inverse, a variables mapping in the
same grammar made from a parameter tree.  TensorFlow is only imported to
READ a checkpoint file (``tf.train.load_checkpoint`` — the modern
``NewCheckpointReader``), inside ``read_tf1_checkpoint``; pass a plain
``{name: array}`` dict to stay TF-free (a machine without tensorflow can
still import such a mapping).

The port's copy of ``ecog2txt_tpu/utils/tf1_import.py``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "read_tf1_checkpoint",
    "import_tf1_checkpoint",
    "recover_model_sizes",
    "tf1_variables_from_params",
]

_EMA_SUFFIX = "/ExponentialMovingAverage"
_WEIGHT_LEAVES = ("weights", "kernel", "w")
_BIAS_LEAVES = ("biases", "bias", "b")


def read_tf1_checkpoint(path: str) -> dict[str, np.ndarray]:
    """All variables of a TF1-format checkpoint as ``{name: ndarray}``
    (reference trainers.py:452: ``NewCheckpointReader``)."""
    import tensorflow as tf  # only to read a file; not a dependency of the port

    reader = tf.train.load_checkpoint(path)
    return {
        name: np.asarray(reader.get_tensor(name))
        for name in reader.get_variable_to_shape_map()
    }


def recover_model_sizes(
    source: str | Mapping[str, np.ndarray],
) -> dict[str, Any]:
    """Architecture hyperparameters from a TF1 checkpoint's tensor
    shapes — the reference's ``recover_model_sizes``
    (trainers.py:444-554) for checkpoints that predate this framework.
    Returns the same dict shape ``utils.introspect.recover_model_sizes``
    produces from a parameter tree, so
    ``MultiSubjectTrainer.update_net_from_saved_model`` consumes either
    source; adds an ``"EMA"`` flag (shadow variables present)."""
    variables = (
        read_tf1_checkpoint(source) if isinstance(source, str) else dict(source)
    )
    layer_sizes: dict[str, dict[int, int]] = {}
    strides: dict[int, int] = {}
    aux_heads: dict[str, int] = {}
    subnet_ids: set[str] = set()
    out: dict[str, Any] = {"encoder_type": "lstm", "EMA": False}
    proj_groups: dict[str, set[int]] = {}
    records = []
    for name, value in variables.items():
        if name.endswith(_EMA_SUFFIX):
            out["EMA"] = True
        rec = _parse(name)
        if rec is None or rec["ema"] or rec["leaf"] != "w":
            continue
        records.append((rec, np.asarray(value).shape))
        if rec["kind"] == "proj":
            proj_groups.setdefault(rec["scope"], set()).add(rec["layer"])
        if rec["subnet_id"] is not None:
            subnet_ids.add(rec["subnet_id"])
    for rec, shape in records:
        kind, layer = rec["kind"], rec.get("layer", 0)
        if kind == "conv":
            # (1, stride, in, out) — trainers.py:534-541
            layer_sizes.setdefault("encoder_embedding", {})[layer] = shape[-1]
            strides[layer] = shape[1] if len(shape) == 4 else 1
            if layer == 0:
                out["in_channels"] = int(shape[-2])
        elif kind == "enc_rnn":
            layer_sizes.setdefault("encoder_rnn", {})[layer] = shape[1] // 4
            if rec["direction"] == "bwd":
                out["BIDIRECTIONAL"] = True
        elif kind == "dec_rnn":
            layer_sizes.setdefault("decoder_rnn", {})[layer] = shape[1] // 4
        elif kind == "emb":
            layer_sizes.setdefault("decoder_embedding", {})[0] = shape[1]
            out["vocab_size"] = int(shape[0])
        elif kind == "proj":
            final = layer == max(proj_groups[rec["scope"]])
            if rec["scope"] == "decoder_projection":
                if final:
                    # stored transposed: (out, in) — trainers.py:519-524
                    out["vocab_size"] = int(shape[0])
            else:
                head = rec["scope"].replace("_projection", "_targets")
                if final:
                    aux_heads[head] = int(shape[0])
                else:
                    layer_sizes.setdefault(rec["scope"], {})[layer] = shape[1]
    for key in (
        "encoder_embedding",
        "encoder_rnn",
        "encoder_1_projection",
        "decoder_embedding",
        "decoder_rnn",
    ):
        layer_sizes.setdefault(key, {})
    out["layer_sizes"] = {
        key: [int(sizes[i]) for i in sorted(sizes)]
        for key, sizes in layer_sizes.items()
    }
    if strides:
        out["decimation_factor"] = int(
            np.prod([strides[i] for i in sorted(strides)])
        )
    if aux_heads:
        out["aux_heads"] = aux_heads
    out["num_subjects"] = max(len(subnet_ids), 1)
    out.setdefault("BIDIRECTIONAL", False)
    return out


def _leaf_kind(scopes: Sequence[str]) -> str | None:
    leaf = scopes[-1].lower()
    if leaf in _WEIGHT_LEAVES:
        return "w"
    if leaf in _BIAS_LEAVES:
        return "b"
    return None


def _split_lstm_kernel(kernel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """TF1 packs ``[x; h] @ K`` with ``K: (in+H, 4H)`` → our (wx, wh)."""
    four_h = kernel.shape[1]
    hidden = four_h // 4
    in_dim = kernel.shape[0] - hidden
    return kernel[:in_dim], kernel[in_dim:]


def import_tf1_checkpoint(
    source: str | Mapping[str, np.ndarray],
    params: dict,
    ema: dict | None = None,
    subject_ids: Sequence[Any] | None = None,
) -> tuple[dict, dict | None, dict[str, list[str]]]:
    """Map a TF1 checkpoint's weights onto (params, ema) pytrees.

    ``subject_ids`` orders ``subnet_<id>`` scopes onto the stacked
    subject axis (defaults to sorted numeric order of the ids found).
    Returns new pytrees (inputs are not mutated) plus a report with
    ``imported`` / ``skipped`` variable-name lists.  Variables with no
    counterpart in the pytree (e.g. optimizer slots) are skipped, not
    errors; a SHAPE mismatch on a mapped variable is a ValueError.
    """
    variables = (
        read_tf1_checkpoint(source) if isinstance(source, str) else dict(source)
    )
    params = _tree_copy(params)
    ema = _tree_copy(ema) if ema is not None else None
    report: dict[str, list[str]] = {"imported": [], "skipped": []}

    # discover subnet ids for the stacked subject axis
    found_ids = sorted(
        {
            m.group(1)
            for name in variables
            for m in [re.match(r"seq2seq/subnet_([^/]+)/", name)]
            if m
        },
        key=lambda s: (not s.isdigit(), int(s) if s.isdigit() else s),
    )
    if subject_ids is not None:
        id_index = {str(s): i for i, s in enumerate(subject_ids)}
    else:
        id_index = {s: i for i, s in enumerate(found_ids)}

    # group projection layers per scope first: only the MAX layer number
    # of a *_projection scope is the transposed final layer
    proj_layers: dict[tuple, set[int]] = {}
    records = []
    for name, value in variables.items():
        rec = _parse(name)
        if rec is None:
            report["skipped"].append(name)
            continue
        records.append((name, value, rec))
        if rec["kind"] == "proj":
            proj_layers.setdefault(
                (rec["subnet_id"], rec["scope"], rec["ema"]), set()
            ).add(rec["layer"])

    for name, value, rec in records:
        tree = ema if rec["ema"] else params
        if tree is None:
            report["skipped"].append(name)
            continue
        try:
            ok = _assign(tree, rec, value, id_index, proj_layers)
        except (KeyError, IndexError, TypeError):
            ok = False
        if ok:
            report["imported"].append(name)
        else:
            report["skipped"].append(name)
    return params, ema, report


def _tree_copy(tree):
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v) for v in tree]
    return tree


def _parse(name: str) -> dict | None:
    """One checkpoint variable name → a mapping record, or None."""
    ema = name.endswith(_EMA_SUFFIX)
    if ema:
        name = name[: -len(_EMA_SUFFIX)]
    scopes = name.split("/")
    if scopes[0] != "seq2seq" or len(scopes) < 3:
        return None
    scopes = scopes[1:]
    subnet_id = None
    m = re.match(r"subnet_(.+)$", scopes[0])
    if m:
        subnet_id = m.group(1)
        scopes = scopes[1:]
    leaf = _leaf_kind(scopes)
    if leaf is None:
        return None
    head = scopes[0]

    # RNN: a cell_<n> scope anywhere (reference trainers.py:481-487)
    cell = next(
        (
            int(mm.group(1))
            for s in scopes
            for mm in [re.match(r"cell_(\d+)$", s)]
            if mm
        ),
        None,
    )
    if cell is not None:
        mm = re.match(r"encoder_rnn_(\d+)$", head)
        if mm:
            direction = "bwd" if any(
                s in ("bw", "backward") for s in scopes
            ) else "fwd"
            return {
                "kind": "enc_rnn",
                "layer": int(mm.group(1)),
                "direction": direction,
                "leaf": leaf,
                "subnet_id": subnet_id,
                "ema": ema,
            }
        if head.startswith("decoder_rnn"):
            return {
                "kind": "dec_rnn",
                "layer": cell,
                "leaf": leaf,
                "subnet_id": subnet_id,
                "ema": ema,
            }
        return None

    # feed-forward: <scope>_<n>_<n>_<layer> (reference trainers.py:489-495)
    mm = re.match(r"(.+)_(\d+)_(\d+)_(\d+)$", head)
    if not mm:
        return None
    scope, layer = mm.group(1), int(mm.group(4))
    if scope == "encoder_embedding":
        kind = "conv"
    elif scope == "decoder_embedding":
        kind = "emb"
    elif scope.endswith("_projection"):
        kind = "proj"
    else:
        return None
    return {
        "kind": kind,
        "scope": scope,
        "layer": layer,
        "leaf": leaf,
        "subnet_id": subnet_id,
        "ema": ema,
    }


def _set(container, key, value, name=""):
    old = container[key]
    value = np.asarray(value)
    if tuple(old.shape) != value.shape:
        raise ValueError(
            f"shape mismatch importing {name or key}: checkpoint "
            f"{value.shape} vs model {tuple(old.shape)}"
        )
    container[key] = _like(old, value)


def _like(old: torch.Tensor, value) -> torch.Tensor:
    """``value`` as a tensor on ``old``'s device in ``old``'s dtype."""
    return torch.as_tensor(np.ascontiguousarray(value)).to(
        device=old.device, dtype=old.dtype
    )


def _assign(tree, rec, value, id_index, proj_layers) -> bool:
    kind, leaf = rec["kind"], rec["leaf"]
    if kind == "conv":
        layer = tree["subnet"]["conv"][rec["layer"]]
        s = id_index.get(str(rec["subnet_id"]), 0 if rec["subnet_id"] is None else None)
        if s is None:
            return False
        if leaf == "w":
            # (1, stride, in, out) → (stride·in, out): row-major reshape
            # matches the conv-as-GEMM patch layout
            # (models/seq2seq.py convolve_sequences)
            w = np.asarray(value).reshape(-1, value.shape[-1])
            _stack_set(layer, "w", s, w)
        else:
            _stack_set(layer, "b", s, np.asarray(value))
        return True
    if kind == "emb":
        if leaf != "w":
            return False
        _set(tree["decoder"], "embedding", value)
        return True
    if kind in ("enc_rnn", "dec_rnn"):
        p = (
            tree["encoder"]["rnn"][rec["layer"]][rec["direction"]]
            if kind == "enc_rnn"
            else tree["decoder"]["rnn"][rec["layer"]]
        )
        if leaf == "w":
            wx, wh = _split_lstm_kernel(np.asarray(value))
            _set(p, "wx", wx)
            _set(p, "wh", wh)
        else:
            _set(p, "b", value)
        return True
    if kind == "proj":
        group = proj_layers[(rec["subnet_id"], rec["scope"], rec["ema"])]
        final = rec["layer"] == max(group)
        if rec["scope"] == "decoder_projection":
            if not final:
                return False  # model has no hidden decoder projection
            target = tree["decoder"]["out"]
        else:
            head = rec["scope"].replace("_projection", "_targets")
            aux = tree["aux"].get(head)
            if aux is None:
                return False
            target = aux["out"] if final else aux["mlp"][rec["layer"]]
        if leaf == "w":
            w = np.asarray(value)
            if final:
                w = w.T  # final projection stored (out, in) in TF1
            _set(target, "w", w)
        else:
            _set(target, "b", value)
        return True
    return False


def _stack_set(layer, key, subject_index, value):
    """Write one subject's row of a stacked ``(S, ...)`` subnet leaf."""
    old = layer[key]
    if value.shape != tuple(old.shape[1:]):
        raise ValueError(
            f"shape mismatch importing subnet {key}: checkpoint "
            f"{value.shape} vs model {tuple(old.shape[1:])}"
        )
    new = old.detach().clone()
    new[subject_index] = _like(old, value)
    layer[key] = new


def tf1_variables_from_params(
    params: dict,
    conv_strides: Sequence[int],
    subject_ids: Sequence[Any],
    ema: dict | None = None,
) -> dict[str, np.ndarray]:
    """A parameter tree (and its EMA twin as ``.../ExponentialMovingAverage``
    shadows) as TF1 checkpoint variables in the reference's grammar: the
    inverse of :func:`import_tf1_checkpoint` on the leaves the grammar
    names (subnet convs, encoder biLSTM, aux projections of ``*_targets``
    heads, decoder embedding, LSTM and output).  ``conv_strides`` splits
    each conv kernel into ``(1, stride, in, out)``; ``subject_ids`` names
    the ``subnet_<id>`` scopes of the stacked subject axis.  A leaf the
    grammar has no name for (a bridge, cross-attention, a conformer
    encoder) raises ``ValueError``."""
    def host(t) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    def tree_vars(tree) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        named = set()

        def put(name, leaf_id, value):
            out[name] = value
            named.add(leaf_id)

        for i, (layer, stride) in enumerate(
            zip(tree["subnet"]["conv"], conv_strides)
        ):
            w, b = host(layer["w"]), host(layer["b"])
            C, F = w.shape[1] // stride, w.shape[2]
            for s, sid in enumerate(subject_ids):
                scope = f"seq2seq/subnet_{sid}/encoder_embedding_{C}_{F}_{i}"
                put(f"{scope}/weights", id(layer["w"]), w[s].reshape(1, stride, C, F))
                put(f"{scope}/biases", id(layer["b"]), b[s])
        for l, layer in enumerate(tree["encoder"].get("rnn", ())):
            for direction, tf_dir in (("fwd", "fw"), ("bwd", "bw")):
                if direction not in layer:
                    continue
                p = layer[direction]
                scope = (
                    f"seq2seq/encoder_rnn_{l}/bidirectional_rnn/{tf_dir}/"
                    "cell_0/lstm_cell"
                )
                put(f"{scope}/kernel", id(p["wx"]),
                    np.concatenate([host(p["wx"]), host(p["wh"])], axis=0))
                named.add(id(p["wh"]))
                put(f"{scope}/bias", id(p["b"]), host(p["b"]))
        for head, p in tree["aux"].items():
            if not head.endswith("_targets"):
                continue
            scope = head[: -len("_targets")] + "_projection"
            layers = list(p["mlp"]) + [p["out"]]
            for j, layer in enumerate(layers):
                w = host(layer["w"])
                final = j == len(layers) - 1
                name = f"seq2seq/{scope}_{w.shape[0]}_{w.shape[1]}_{j}"
                put(f"{name}/weights", id(layer["w"]), w.T if final else w)
                put(f"{name}/biases", id(layer["b"]), host(layer["b"]))
        dec = tree["decoder"]
        V, E = dec["embedding"].shape
        put(f"seq2seq/decoder_embedding_{V}_{E}_0/weights", id(dec["embedding"]),
            host(dec["embedding"]))
        for l, p in enumerate(dec["rnn"]):
            scope = f"seq2seq/decoder_rnn/cell_{l}/lstm_cell"
            put(f"{scope}/kernel", id(p["wx"]),
                np.concatenate([host(p["wx"]), host(p["wh"])], axis=0))
            named.add(id(p["wh"]))
            put(f"{scope}/bias", id(p["b"]), host(p["b"]))
        D = dec["out"]["w"].shape[0]
        name = f"seq2seq/decoder_projection_{D}_{V}_0"
        put(f"{name}/weights", id(dec["out"]["w"]), host(dec["out"]["w"]).T)
        put(f"{name}/biases", id(dec["out"]["b"]), host(dec["out"]["b"]))
        from ..convert import tree_leaves

        unnamed = [t for t in tree_leaves(tree) if id(t) not in named]
        if unnamed:
            raise ValueError(
                f"{len(unnamed)} parameter leaves have no TF1 name (bridge, "
                "cross-attention or a conformer encoder)"
            )
        return out

    variables = tree_vars(params)
    if ema is not None:
        variables.update(
            {f"{k}{_EMA_SUFFIX}": v for k, v in tree_vars(ema).items()}
        )
    return variables
