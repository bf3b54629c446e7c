"""CTC phoneme head: alignment-free loss, greedy decode, and
lexicon-constrained word rescoring.

The port's own copy of ``ecog2txt_tpu/models/ctc.py`` with the same
names and behaviour:

* :func:`ctc_loss` computes what optax's ``ctc_loss`` computes (the JAX
  package's loss): the forward (alpha) recursion over blank and label
  states in log space, ``log_epsilon = -1e5`` standing for log 0, so a
  label that cannot be aligned within its frames gives a large finite
  loss (``F.ctc_loss`` would give ``inf``).  It is plain PyTorch, a loop
  over the encoder steps, differentiable by autograd; the JAX side is
  optax's XLA code, not a TPU kernel;
* :func:`ctc_greedy_decode` (best path: argmax, collapse repeats, drop
  blanks) and :func:`collapse_alignment`;
* the lexicon-constrained CTC prefix beam search (Hannun et al. 2014):
  :class:`LexiconTrie`, the carryable :class:`CTCWordBeamState` (a
  Python oracle and the repository's C++ search ``native/ctcbeam.cpp``,
  built with ``g++`` into the package's ``_build/`` at first use),
  :func:`ctc_word_beam_search` and :func:`build_lexicon`.

The blank is the LAST class, so phoneme ids keep their vocab positions.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import weakref
from typing import Sequence

import numpy as np
import torch

# optax's stand-in for log(0)
LOG_EPSILON = -1e5


def _ctc_per_sequence(logprobs, logit_paddings, labels, label_lengths, blank_id):
    """optax's ``ctc_loss_with_forward_probs`` loss per sequence: ``(B,)``.

    ``logprobs`` (B, T, K) log-softmaxed, ``logit_paddings`` (B, T) 1.0 at
    padded steps, ``labels`` (B, N) right-padded, ``label_lengths`` (B,).
    The same updates in the same order as optax's scan body."""
    B, T, _ = logprobs.shape
    N = labels.shape[1]
    eps = LOG_EPSILON
    like = dict(dtype=logprobs.dtype, device=logprobs.device)
    labels = labels.long()
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype)
    repeat = torch.cat([repeat, torch.zeros((B, 1), **like)], dim=1)  # (B, N)
    logprobs_phi = logprobs[:, :, blank_id]  # (B, T)
    logprobs_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(B, T, N)
    )  # (B, T, N)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)

    phi = torch.cat([torch.zeros((B, 1), **like), torch.full((B, N), eps, **like)], dim=1)
    emit = torch.full((B, N), eps, **like)
    for t in range(T):
        lp_emit = logprobs_emit[:, t]
        lp_phi = logprobs_phi[:, t : t + 1]
        pad = logit_paddings[:, t : t + 1]
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = prev_phi + lp_phi
        next_phi = update_phi(next_phi, emit + lp_phi + eps * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, label_lengths.long()[:, None])[:, 0]


def ctc_loss(
    logits: torch.Tensor,  # (T, B, K+1) time-major encoder-head logits
    logit_lengths: torch.Tensor,  # (B,)
    labels: torch.Tensor,  # (B, L) int phoneme ids (no blanks)
    label_lengths: torch.Tensor,  # (B,)
    normalizer: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean per-label-token CTC negative log-likelihood, a scalar in f32
    (or the wider dtype of the logits).  ``normalizer`` replaces the
    batch's label-token count as the divisor (a data-parallel rank divides
    its sum by the global batch's count)."""
    dtype = torch.promote_types(logits.dtype, torch.float32)
    logits_bm = logits.to(dtype).transpose(0, 1)  # (B, T, K+1)
    B, T = logits_bm.shape[:2]
    dev = logits_bm.device
    logit_paddings = (
        torch.arange(T, device=dev)[None, :] >= logit_lengths.to(dev)[:, None]
    ).to(dtype)
    blank_id = logits.shape[-1] - 1
    per_seq = _ctc_per_sequence(
        torch.log_softmax(logits_bm, dim=-1), logit_paddings, labels.to(dev),
        label_lengths.to(dev), blank_id,
    )
    count = label_lengths.to(dev).sum() if normalizer is None else normalizer
    return per_seq.sum() / torch.clamp(count, min=1).to(dtype)


def collapse_alignment(aligned) -> np.ndarray:
    """Frame-aligned labels → label sequence (merge repeats)."""
    aligned = np.asarray(aligned)
    if len(aligned) == 0:
        return aligned
    keep = np.ones(len(aligned), bool)
    keep[1:] = aligned[1:] != aligned[:-1]
    return aligned[keep]


def ctc_greedy_decode(logits: torch.Tensor, lengths) -> list[list[int]]:
    """Best-path decode of (T, B, K+1) logits: argmax per step, collapse
    repeats, drop blanks."""
    blank = logits.shape[-1] - 1
    path = torch.argmax(logits, dim=-1).cpu().numpy()  # (T, B)
    lengths = np.asarray(lengths.cpu() if torch.is_tensor(lengths) else lengths)
    out = []
    for b in range(path.shape[1]):
        seq = collapse_alignment(path[: lengths[b], b])
        out.append([int(p) for p in seq if p != blank])
    return out


# --------------------------------------------------------------------------
# lexicon trie + prefix beam search
# --------------------------------------------------------------------------


class LexiconTrie:
    """Phoneme-sequence trie over a word vocabulary.

    ``lexicon``: {word: [phoneme ids]}.  Node = dict phoneme_id → node;
    words that END at a node are stored under the ``words`` key."""

    def __init__(self, lexicon: dict[str, Sequence[int]]):
        self.root: dict = {"words": []}
        for word, phonemes in lexicon.items():
            node = self.root
            for p in phonemes:
                node = node.setdefault(int(p), {"words": []})
            node["words"].append(word)

    def children(self, node: dict) -> list[int]:
        return [k for k in node if k != "words"]


# --------------------------------------------------------------------------
# native (C++) search backend: the repository's native/ctcbeam.cpp, built
# into the package's _build/ (listed in .gitignore); the source is read,
# not copied
# --------------------------------------------------------------------------

_NATIVE_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "ctcbeam.cpp",
)
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
_lib = None
_lib_tried = False


def _load_native():
    """The C++ search library, built on first use; None when the source is
    missing or the build fails (the Python oracle then runs)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_NATIVE_SRC):
        return None
    try:
        os.makedirs(_NATIVE_DIR, exist_ok=True)
    except OSError:
        return None
    so_path = os.path.join(_NATIVE_DIR, "libctcbeam.so")
    if not (
        os.path.exists(so_path)
        and os.path.getmtime(so_path) >= os.path.getmtime(_NATIVE_SRC)
    ):
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               _NATIVE_SRC, "-o", so_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:  # pragma: no cover
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ctcbeam_trie_new.restype = ctypes.c_void_p
    lib.ctcbeam_trie_free.argtypes = [ctypes.c_void_p]
    lib.ctcbeam_trie_add.restype = ctypes.c_int32
    lib.ctcbeam_trie_add.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ctcbeam_state_new.restype = ctypes.c_void_p
    lib.ctcbeam_state_new.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_double,
    ]
    lib.ctcbeam_state_free.argtypes = [ctypes.c_void_p]
    lib.ctcbeam_advance.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_int32,
    ]
    lib.ctcbeam_best.restype = ctypes.c_long
    lib.ctcbeam_best.argtypes = [ctypes.c_void_p, i32p, ctypes.c_long]
    lib.ctcbeam_best_score.restype = ctypes.c_double
    lib.ctcbeam_best_score.argtypes = [ctypes.c_void_p]
    lib.ctcbeam_num_steps.restype = ctypes.c_long
    lib.ctcbeam_num_steps.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _native_trie(trie: LexiconTrie):
    """Build (and cache on the LexiconTrie) the C++ trie + word table.
    Returns (handle, words list) or None when the library is absent or
    the lexicon's ids overflow its packed beam keys."""
    lib = _load_native()
    if lib is None:
        return None
    cached = getattr(trie, "_native", None)
    if cached is not None:
        return cached if cached is not False else None
    handle = lib.ctcbeam_trie_new()
    words: list[str] = []
    stack = [(trie.root, [])]
    while stack:
        node, path = stack.pop()
        for word in node["words"]:
            arr = np.asarray(path, dtype=np.int32)
            ok = lib.ctcbeam_trie_add(
                handle,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(path),
                len(words),
            )
            if not ok:
                # an id overflows the C++ packed beam-key fields (phoneme
                # id > 510 or > 2^23-1 trie nodes): the Python search runs
                lib.ctcbeam_trie_free(handle)
                trie._native = False
                return None
            words.append(word)
        for p in trie.children(node):
            stack.append((node[p], path + [p]))
    weakref.finalize(trie, lib.ctcbeam_trie_free, handle)
    trie._native = (handle, words)
    return trie._native


def _logsumexp2(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _merged_by_words(beams: dict) -> dict:
    """Completed-word hypotheses (no dangling partial), beams that differ
    only in their last phoneme merged."""
    by_words: dict[tuple, float] = {}
    for (words, partial, _last), (_node, pb, pnb) in beams.items():
        if partial:
            continue
        score = _logsumexp2(pb, pnb)
        by_words[words] = _logsumexp2(by_words.get(words, -math.inf), score)
    return by_words


class CTCWordBeamState:
    """Carryable lexicon-constrained CTC prefix-beam state.

    ``advance`` over a stream of chunks gives EXACTLY the beams of one
    ``advance`` over their concatenation (the search is a per-step
    recurrence, pruned after every step), so a streaming ``partial()``
    costs O(new steps) a call.

    Beam key: (words emitted, partial phoneme tuple, last phoneme id) →
    [trie node, log p ending in blank/boundary, log p ending non-blank];
    ``last`` is part of the key, so the repeat-needs-blank gate applies
    with the right phoneme.

    Runs the C++ search (``native/ctcbeam.cpp``) when it builds;
    ``use_native=False`` keeps the Python oracle, ``True`` requires the
    C++ one.  Natural lexicons carry exactly tied beams (word
    segmentation twins), and once pruning cuts inside a tied group the
    two may keep different members: ``best_score()`` is the quantity
    that agrees across backends."""

    def __init__(
        self,
        trie: LexiconTrie,
        beam_width: int = 16,
        word_insertion_bonus: float = 0.0,
        use_native: bool | None = None,
    ):
        self.trie = trie  # also keeps the cached native trie alive
        self.beam_width = beam_width
        self.bonus = word_insertion_bonus
        self.beams: dict[tuple, list] = {((), (), -1): [trie.root, 0.0, -math.inf]}
        self.num_steps = 0
        self._h = None
        if use_native is None or use_native:
            native = _native_trie(trie)
            if native is not None:
                self._lib = _load_native()
                self._trie_handle, self._words = native
                self._h = self._lib.ctcbeam_state_new(
                    self._trie_handle, beam_width, word_insertion_bonus
                )
                self._finalizer = weakref.finalize(
                    self, self._lib.ctcbeam_state_free, self._h
                )
            elif use_native:
                raise RuntimeError(
                    "native ctcbeam backend unavailable (build failed, or "
                    "the lexicon's ids overflow its packed beam keys)"
                )

    def advance(self, log_probs: np.ndarray) -> "CTCWordBeamState":
        """Consume (T_new, K+1) posterior rows; returns self."""
        if self._h is not None:
            logp = np.ascontiguousarray(log_probs, dtype=np.float64)
            T, K1 = logp.shape
            self._lib.ctcbeam_advance(
                self._h,
                logp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                T,
                K1,
            )
            self.num_steps += T
            return self
        trie = self.trie
        blank = log_probs.shape[1] - 1
        NEG = -math.inf
        beams = self.beams
        for t in range(log_probs.shape[0]):
            lp = log_probs[t]
            new: dict[tuple, list] = {}

            def add(key, node, pb, pnb):
                if key in new:
                    entry = new[key]
                    entry[1] = _logsumexp2(entry[1], pb)
                    entry[2] = _logsumexp2(entry[2], pnb)
                else:
                    new[key] = [node, pb, pnb]

            for (words, partial, last), (node, pb, pnb) in beams.items():
                total = _logsumexp2(pb, pnb)
                # 1) blank: prefix unchanged
                add((words, partial, last), node, total + lp[blank], NEG)
                # 2) repeat of the last non-blank phoneme: same prefix
                if last >= 0 and pnb != NEG:
                    add((words, partial, last), node, NEG, pnb + lp[last])
                # 3) extend with a phoneme the trie allows
                for p in trie.children(node):
                    child = node[p]
                    # a repeated phone needs an intervening blank
                    src = total if p != last else pb
                    if src == NEG:
                        continue
                    npnb = src + lp[p]
                    add((words, partial + (p,), p), child, NEG, npnb)
                    # or close out any word completed at this node
                    for word in child["words"]:
                        add((words + (word,), (), p), trie.root, NEG, npnb + self.bonus)
            scored = sorted(new.items(), key=lambda kv: -_logsumexp2(kv[1][1], kv[1][2]))
            beams = dict(scored[: self.beam_width])
        self.beams = beams
        self.num_steps += log_probs.shape[0]
        return self

    def best(self) -> list[str]:
        """Best completed-word hypothesis so far (does not mutate, so it
        can be called after every chunk)."""
        if self._h is not None:
            cap = self.num_steps + 1  # one word needs at least one step
            out = np.empty(cap, dtype=np.int32)
            n = self._lib.ctcbeam_best(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap
            )
            return [self._words[i] for i in out[: min(n, cap)]]
        by_words = _merged_by_words(self.beams)
        if by_words:
            return list(max(by_words.items(), key=lambda kv: kv[1])[0])
        if self.beams:
            (words, _, _), _ = max(
                self.beams.items(), key=lambda kv: _logsumexp2(kv[1][1], kv[1][2])
            )
            return list(words)
        return []

    def best_score(self) -> float:
        """Merged log score of :meth:`best`'s hypothesis (the quantity
        that agrees across backends)."""
        if self._h is not None:
            return float(self._lib.ctcbeam_best_score(self._h))
        by_words = _merged_by_words(self.beams)
        if by_words:
            return max(by_words.values())
        if self.beams:
            return max(_logsumexp2(e[1], e[2]) for e in self.beams.values())
        return -math.inf


def ctc_word_beam_search(
    log_probs: np.ndarray,  # (T, K+1) posteriors for ONE utterance
    trie: LexiconTrie,
    beam_width: int = 16,
    word_insertion_bonus: float = 0.0,
) -> list[str]:
    """Lexicon-constrained CTC prefix beam search → best word sequence
    (the from-scratch search: a one-shot :class:`CTCWordBeamState`)."""
    return (
        CTCWordBeamState(trie, beam_width, word_insertion_bonus)
        .advance(log_probs)
        .best()
    )


def build_lexicon(
    words: Sequence[str],
    word_to_phonemes,
    phoneme_list: Sequence[str],
) -> dict[str, list[int]]:
    """Word vocab (``word_``-suffixed entries, e.g. vocab.demo.36) →
    {word: phoneme-id sequence}."""
    index = {p: i for i, p in enumerate(phoneme_list)}
    lexicon = {}
    for token in words:
        word = token.rstrip("_")
        if not word or token.startswith("<"):
            continue
        phonemes = [index[p] for p in word_to_phonemes(word) if p in index]
        if phonemes:
            lexicon[word] = phonemes
    return lexicon
