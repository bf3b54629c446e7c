"""Drive the PyTorch/CUDA port (``ecog2txt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run (non-zero exit) on any error:

1. environment: the card's name and power limit, CUDA / nvcc / triton
   versions, and the time to build the kernels from ``csrc/`` (one nvcc
   per source, all started together);
2. kernels: every kernel against its plain PyTorch version on the card.
   The forward recurrence K1f at the serving shapes (H=400, T'=104, B in
   {1, 256}); the adjoint K1b at the full-width training shapes (B in
   {16, 256}); both at the demo trainer's own shapes (B=16, H=64, the
   demo's T').  Forward and reverse time, f32 and bf16, ragged lengths,
   a mask that is not all ones, a nonzero initial state (and nonzero
   upstream gradients for K1b); then the autograd Function's gradients
   against autograd through the plain forward at f32.  CUDA-event timings of
   each kernel, its plain version and a one-call library yardstick,
   beside the least time the card could take (``bound_ms``).  Then the
   one-launch biLSTM grid K4f / K4b at the same shapes (both directions,
   ragged lengths, 0/2 masks, nonzero upstream gradients), the row
   LayerNorm K5f / K5b at the conformer's headline rows (B=256 x T'=104,
   D=384), the long recording's (B=16 x T'=8192) and at D=64 and D=100,
   both Functions' gradients, and their timings beside cuDNN's
   bidirectional ``nn.LSTM``, ``F.layer_norm`` and, for K4f, the two K1f
   launches it replaces;
3. serving (a main path): the full-width biLSTM model of the JAX
   package's benchmark configuration (469 channels, conv 100 / stride
   12, 3x400 biLSTM, LSTM-800 decoder, vocab 1809, bf16, random weights
   from seed 0) answers single utterances of 1248, 1000 and 600 samples
   and a batch of 256 through ``OnlinePredictor``, then a
   ``StreamingSession`` fed in 4 ragged chunks.  Kernel launch counts
   are reset before and read after; each encode must launch the
   recurrence kernel 6 times.  Encoder outputs are held to the plain
   path (bf16 tolerance), and at f32 the kernel path's tokens must equal
   the plain path's.  Last, one B=1 and one B=256 request run under
   ``torch.profiler``: device time by kernel category beside wall time;
4. training (a main path): the same model with dropout on, B=256 x 1248
   samples from a random device-resident corpus of 450 trials (seed 0),
   a few steps of the port's segment runner (loss, gradients through
   K1f and K1b, clip, Adam, EMA).  Each step must launch K1f and K1b 6
   times each, and the loss must stay finite and fall.  Then ms per
   step and sentences/s, one step under ``torch.profiler``, and at f32
   the kernel path's loss and gradient leaves against the plain path's
   on one batch with the same dropout masks;
5. the trainer (a main path): ``MultiSubjectTrainer`` on the synthetic
   demo experiment at its own widths, bf16, kernels on, trained through
   ``parallel_transfer_learn`` for a few assessment intervals: training
   WER must fall, and K1b must launch 2 x len(encoder_rnn) times per
   step.  One validation trial is then served through
   ``OnlinePredictor.from_trainer``.  Then the phase 3 model under
   ``use_pallas_lstm='bi_grid'`` (a main path): B=1 requests, a B=256
   batch and a stream, 3 K4f launches per encode and no other kernel,
   f32 tokens equal to the plain path's; and phase 4's training under
   'bi_grid' (a main path): 3 K4f + 3 K4b launches per step, no K1f or
   K1b, a falling loss, f32 loss and gradients against the plain path;
6. attention kernels: K2f, K2b-dq, K2b-dkv and K3f against their plain
   versions in f32 and bf16, full and ragged lengths, at the headline
   conformer's training and serving shape (B=256, T'=104, D=384, H=6,
   C=16, L=1), B=17, the ``ConformerStream`` window (B=1, T'=144, offsets -64
   and 256), the long recording (B=16, T'=8192), the conformer demo
   trainer's own shape and head dims 48 and 96 (B=16, 8 and 4 heads); the two autograd Functions' gradients against
   autograd through the plain forwards (f32); CUDA-event timings beside
   each kernel's bound and ``scaled_dot_product_attention`` as the
   yardstick of K2f and K2b;
7. conformer serving (a main path): the serving model with its encoder
   swapped for the JAX package's headline conformer (bench.py:149-157,
   4 blocks of width 384, bf16, random weights from seed 0) answers B=1
   and B=256 requests through ``OnlinePredictor`` under
   ``attention_impl='flash'`` (4 K2f launches per encode) and ``'fused'``
   (4 K3f); no backward kernel runs.  f32 tokens equal the plain
   (banded) path's; then ``ConformerStream`` (flash, f32) equals the
   offline encode chunk by chunk, a ragged final chunk included;
8. conformer training (a main path): B=256 x 1248 samples, bf16,
   dropout on, a few segment-runner steps under 'flash' then 'fused':
   per step 4 forward launches, 4 K2b-dq and 4 K2b-dkv, a falling loss,
   a profile by kernel category, and at f32 the loss and every gradient
   leaf of both paths against the plain path; the long recording:
   ``conformer_encode`` forward and backward at B=16, T'=8192 under
   'auto', which must launch K2f and K2b (tokens/s);
9. the conformer demo trainer (a main path): ``MultiSubjectTrainer`` on
   the demo experiment with a small flash conformer, bf16: training WER
   must fall, with 2 K2b-dq and 2 K2b-dkv launches per step;
K1f, K1b, K4f, K4b, K2f, K2b-dq, K2b-dkv and K3f have two bodies each,
chosen up front by dtype (and shape): bf16 runs the cluster bodies of the
LSTM forward and adjoint (``csrc/lstm_fwd_cluster.cuh``,
``csrc/lstm_bwd_cluster.cuh``: K1f / K1b one direction a launch, K4f /
K4b both with a direction axis) and the attention kernels' tensor-core
bodies (``csrc/banded_attention_tc.cu``, ``csrc/banded_attention_bwd_tc.cu``,
``csrc/fused_attention_tc.cu``), f32 the rows and CUDA-core bodies.  K5b
has two bodies chosen by the row's width: the registers body (each row
read once) at every width the conformer uses, the columns body above.  Every main path reads
``launches_by_body`` beside its counts and fails unless its bf16 launches
went through the new body (the f32 cases through the old one).  Phase 2
holds K1f and K1b at B=1, 16, 17 and 256 (H=400) and the demo width (K1b
at H=100 too), and K4f and K4b at the same batches at H=400 and H=100,
bit-identical on repeat (K4f's and K4b's cluster bodies equal to two K1f
/ K1b launches bit for bit; K1f's row 0 alone equal to row 0 in B=17);
phase 6 holds K3f at head dims 288, 384, 454 and 512 too (at the block
and body the layer plans: bf16 on the tensor cores; f32 512 on 16-column
streamed tiles), its tensor-core body bit-identical on repeat and row 0 of
B=17 equal to B=1 bit for bit, and ``banded_flash_attention`` at head dim
256 in both dtypes at the query block it plans; both bodies of K1f, K1b,
K4f, K4b, K2f, K2b, K3f and K5b are timed at bf16, in turns (K1f and K4f
with cuDNN in the same turns, and at 16 and 32 rows a cluster; K3f at B=1
at the 128-row block and the one the layer plans).
Every conformer path also counts its LayerNorm launches: 5 K5f per block
and encode (4 under 'fused', where K3f normalises inside) and as many K5b
per training step; the flash training step is timed once more with the
LayerNorm swapped back to the plain math, in turns with K5.

10. beam search (a main path): ``models.beam.beam_decode`` (width 4,
   alpha 0.6) over the full-width biLSTM at B=256 x 1248 samples and B=1
   under True (6 K1f a call: one encode) and 'bi_grid' (3 K4f), timed
   beside the greedy decode; width 1 equals the greedy decode in f32; then
   over the headline conformer under 'fused' (4 K3f);
11. the conformer session (a main path): ``StreamingConformerSession``
   over the headline conformer with a CTC head (the bench's MLP of 225
   units, 21 classes: the phonemes of ``vocab.demo-phonemes.20`` and the
   blank), bf16, B=1, under 'flash' (4 K2f a window encode) and 'fused' (4
   K3f), K5f on every other LayerNorm: ragged packets of a 1248-sample
   utterance with two mid-stream ``decode()``s that must agree, then a
   recording 8x as long a chunk at a time, ``partial()`` greedy and with
   the lexicon of ``vocab.demo.36`` after each chunk (the carried beam
   must equal the from-scratch search); median per-chunk and ``partial()``
   latencies; in f32 the endpoints equal the offline greedy decode;
12. the pool (a main path): ``StreamingSessionPool`` at capacity 8 over the
   same model, a seeded schedule of joins, ragged pushes and leaves: 20 K5f
   a tick and no other kernel (the window's attention is pinned to the
   plain 'dense'); each stream's endpoint against a dedicated session under
   the same impl (bf16 encoder outputs normwise within the bf16 tolerance;
   f32 tokens exact); ``host_upload='int8'`` equal to its session and to
   the offline decode of the dequantized input; the tick time at capacity 8;
13. CTC training (a main path): the same model at B=256, bf16, dropout on,
   a few steps under 'flash' (4 K2f + 4 K2b-dq + 4 K2b-dkv + 20 K5f + 20
   K5b a step), a falling loss; ``ctc_loss`` on the card against the same
   recursion on the CPU, value and gradient (f32);
14. export (a main path): ``export_predictor`` of the full-width biLSTM
   predictor under True and 'bi_grid', loaded back in the same process:
   12 K1f or 6 K4f a call through the program, tokens equal to the live
   predictor's;

15. MoE serving (a main path): the headline conformer with an 8-expert
   top-2 mixture-of-experts second FFN (no-drop), bf16, B=1 and B=256 x
   1248 samples through ``OnlinePredictor`` under 'fused' (4 K3f an
   encode) and 'flash' (4 K2f), K5f on every other LayerNorm (the MoE
   FFN's too); the router aux loss of the B=256 encode finite and
   positive; in f32 both impls' tokens equal the plain path's;
16. MoE training (a main path): the JAX package's MoE cell (capacity
   1.25, dispatch groups of 512 steps, B=16 x T'=2048), bf16, dropout on,
   'flash', a few segment-runner steps (4 K2f + 4 K2b-dq + 4 K2b-dkv + 20
   K5f + 20 K5b a step), the loss finite and falling, ``moe_aux`` > 0; step
   time, encoder tokens/s and a profile by kernel category;
17. int8 serving (a main path): the int8 GEMM (``torch._int_mm``, padded
   to its shapes) against a float64 product on the card, exactly, at the
   conformer's shapes (K=100, 16 rows or fewer); a B=256 encode of
   ``quantize_conformer_params`` within JAX's bounds of the float encode
   (cosine > 0.999, max abs err < 5 % of the max); ``quantize='int8'``
   sessions of phase 11's model under 'flash' and 'fused' (both run K2f:
   K3f reads the float ``wqkv``), per-chunk latency; in f32 the session's
   and the pool's endpoints equal the offline decode with the same
   quantized weights;
18. featurization (a main path): ``extract_high_gamma`` on the JAX
   package's featurization cell (10 s, 469 channels, 3.2 kHz → 200 Hz,
   float and int16) on the card against the same chain on the CPU (f32),
   and its realtime factor;
19. the raw-voltage session (a main path): ``RawVoltageSession`` over phase
   11's model, f32, 'flash', synthetic int16 raw voltage at 3.2 kHz in
   ragged 50-200 ms packets with calibration statistics: ``decode()``
   twice mid-stream equal, the endpoint equal to the offline decode of the
   calibrated offline features; per-push and ``partial()`` medians;

21. the rest of the trainer (main paths) on a two-subject demo experiment
   (a 16x16 donor and a 22x22 target, 484 channels; 32 sentences a block:
   192 and 128 training trials) at the benchmark's widths (conv 100 at
   stride 12, 3x400 biLSTM, aux 225, decoder embedding 150, LSTM 800),
   bf16, True, dropout on, B=64, 4 warmup steps then cosine decay,
   TensorBoard summaries and a checkpoint every assessment:
   ``sequential_transfer_learn(2, 2, 2)`` (K1b 6 times a step in every
   fit, K1f at least as often; the frozen pretraining fit leaves the core
   and the donor's subnet row bit-identical and moves the target's; 8
   epochs; the event file read back holds the loss at every interval and
   the WERs at every assessment); the NaN rollback (learning rate 1e18:
   ``FloatingPointError`` naming the restored epoch, the state the newest
   checkpoint bit for bit); architecture recovery (a 2x64 trainer's
   ``assess_saved_model`` rebuilds 3x400 / 800, 6 K1f an encode, the
   source's WERs); the TF1 import of the parameters as variables of the
   reference's grammar (a mapping: tensorflow is not on the card's
   machine) into a 2x64 trainer, rebuilt, leaves equal bit for bit, the
   same assessment; ``get_saliencies`` (6 K1f + 6 K1b a subject) and
   ``get_internal_activations`` (6 K1f), in f32 their kernel paths
   against the plain paths; ``fit`` under ``max_host_trials`` (a third of
   the largest subject's trials, shards read from the records) against
   ``max_device_trials`` at the same size (parameters within the bf16
   tolerance, the wall time of both).  Then ``export_predictor`` of the
   headline conformer under 'flash' and, at 2 of its 4 blocks (the
   tracing time grows with depth), under 'fused' and of its MoE (no-drop;
   capacity 1.25), f32, 6 decoded tokens, loaded back: calls at B=1, 17
   and 256 (across the depthwise conv's eager crossover) launch a K2f or
   K3f a block and the K5f of an encode through the program, two encodes
   a call, and give the live predictor's tokens.  Last the TF32 check: with cuDNN's default flags
   (TF32 allowed in convolutions) just for it, an f32 headline-conformer
   encode at B=256, T'=104 and the exported 'flash' program at B=256
   against the CPU at the f32 tolerance, the errors printed beside those
   with TF32 off and beside a bare f32 depthwise ``conv1d``'s;

22. data parallelism (a main path over ``torch.distributed``): the
   headline conformer ('flash') and the biLSTM benchmark model (True),
   bf16, dropout off, global B=256 over 2 gloo ranks that share the card
   (``parallel.launch.spawn`` runs ``parallel_rank`` of this file on
   each), and the conformer over 1 NCCL rank: after a warm-up and 3 steps
   the ranks' parameters bit-identical and within the bf16 tolerance of
   the one-process run on the same global batches (the losses too); each
   rank launches the path's kernels every step (4 K2f + 4 K2b-dq + 4
   K2b-dkv + 20 K5f + 20 K5b; 6 K1f + 6 K1b); step times by CUDA events
   (``utils.profiling.StepTimer``) and the conformer step's MFU
   (``utils.flops``, the H100's dense bf16 peak);
23. sequence parallelism: the long recording (B=16, T'=8192) over 2 seq
   ranks: the encode under 'flash' and 'fused' (bf16) and in f32 at
   T'=2048 equal to the one-process encode; one training step's
   gradients (bf16, and f32 at T'=2048) equal to the one-process step's;
   rank 0's window starts at -128 (phase 6 holds that window too);
24. expert parallelism: the MoE cell (8 experts, top 2, capacity 1.25,
   B=16 x T'=2048) over 2 expert ranks, and over 2 x 2 with 2 seq ranks
   (dispatch groups of 128 steps, which divide the shard and the halo):
   the loss, the aux loss and every gradient equal to the one-process
   step's; the gathered checkpoint rank 0 wrote restores in one process;
   a rank that fails or outlasts its spawn's timeout fails the run;
25. the demo twin (``ecog2txt_tpu_torch.run_demo`` at its defaults, f32,
   True) reaches WER 0 on the validation and testing blocks, and the
   decode-quality orderings that ``tests/test_decode_quality.py`` pins
   hold on the card (greedy in (0, 0.3], beam 8 no worse, the CTC head's
   lexicon rescoring below 0.5, transfer better than cold; the
   temperature-1 WER printed beside them);
26-28. tensor and pipeline parallelism and their compositions, full
   width, bf16, dropout off, seed 0, over gloo ranks sharing the card (the
   2- and 4-rank spawns of phases 22-24 and one of 8; ``TP_PP_CASES``): tp=2
   of the biLSTM benchmark model training under True and 'bi_grid' and of
   the headline conformer training under 'flash' and encoding under
   'fused' (B=256), pp=2 (M=2) and pp=4 (a block a stage, M=4) of the
   conformer, dp×tp, dp×pp and tp×pp 2×2, tp×sp and sp×pp 2×2 on the long
   recording's encoder (B=16, T'=8192, ``Σ out·w``), ep×pp 2×2 on the MoE
   cell, and on 8 ranks ep×sp×pp (groups of 128) and tp×sp×pp (the long
   recording), each 2×2×2.  Each case against the one-process run of its
   model (``tp_pp_references``): the first step's summed gradients and the
   parameters' change after two steps, gathered whole (normwise), each
   rank's own leaves against its part of the one-process parameters, the
   replicated leaves bit-identical over the ranks, each rank's launches of
   the path's kernels (exactly), its step time and parameter bytes beside
   the expected pipeline bubble (S−1)/(M+S−1);

29. the experiment sweeps and the electrode contributions (main paths;
   run right after phase 21, on its experiment and its trained trainer):
   ``experiments.perf_vs_training_size`` under ``'bi_grid'`` (2 folds x
   fractions 0.5 and 1.0 of the target's trials, 2 epochs a cell: 3 K4f
   and 3 K4b a step, 3 K4f an assessment encode, no K1f or K1b; the
   archive through ``DecodingResults``, finite WERs),
   ``experiments.grid_search`` over both encoder families and two
   learning rates (biLSTM cells 6 K1f + 6 K1b a step; headline-conformer
   cells, 'flash', 4 K2f + 4 K2b-dq + 4 K2b-dkv + 20 K5f + 20 K5b a step;
   the archive through ``GridSearchResults``, ``best()`` a cell), and
   ``ResultsPlotter(target, trainer).elec_contribs`` for weight norms,
   saliency (6 K1f + 6 K1b a subject) and occlusion (6 K1f a mask
   position's decode and an assessment encode); at f32 the kernel path's
   occlusion WERs equal the plain path's and its saliency contributions
   are within the f32 tolerance normwise.  Seconds a cell (the first
   apart, set-up apart) and for the phase;

30. the examples (main paths; the user entry points of
   ``ecog2txt_tpu_torch.examples``, each through its ``main`` with the
   counts reset just before): ``run_mocha_scale`` at full width (16x16
   grid, 450 training trials, conv 100 / 12, 3x400 biLSTM, aux 225,
   decoder 150 / 800, B=128, bf16, True) for ``MOCHA_EPOCHS`` epochs, K1f
   6 x (steps + assessment encodes) and K1b 6 x steps exactly, all on the
   cluster bodies, the last interval's mean loss below the first's;
   ``stream_long_recording`` at its defaults (K5f, K5b) and under 'flash'
   (K2f, K2b-dq, K2b-dkv too), every sentence streamed == offline;
   ``serve_pool`` (K5f, K5b), pooled == dedicated == offline;
   ``raw_voltage_demo`` under 'bi_grid' (K4f, K4b exactly), validation WER
   at most 0.25 and streamed featurization within 1e-3; ``moe_expert_parallel``
   on 4 gloo ranks sharing the card (experts over 4), streamed == offline
   on every rank; ``migrate_from_reference`` (the stand-in TF1 source is a
   mapping: no tensorflow on the card's machine), the architecture read
   from the source equal to the trainer's, exported tokens == the
   predictor's (K1f, K1b); phase 25 checks the demo twin's electrode
   contributions too;

20. the ``kernels`` JSON line (all ten kernels, with the launches of
   phases 10-19 and 21-30 beside the earlier ones, per rank where ranks
   ran), the card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is
present.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from ecog2txt_tpu_torch import experiments, run_demo, text_dir
from ecog2txt_tpu_torch.assess import wer_vector
from ecog2txt_tpu_torch.convert import load_checkpoint, save_checkpoint, tree_leaves, tree_map
from ecog2txt_tpu_torch.datagen import word_to_phonemes
from ecog2txt_tpu_torch.demo import make_demo_experiment
from ecog2txt_tpu_torch.examples import (
    migrate_from_reference,
    moe_expert_parallel,
    raw_voltage_demo,
    run_mocha_scale,
    serve_pool,
    stream_long_recording,
)
from ecog2txt_tpu_torch.features import (
    HighGammaConfig,
    _next_fast_len,
    calibrate_high_gamma,
    extract_high_gamma,
    extract_high_gamma_np,
    synthesize_raw_from_envelope,
)
from ecog2txt_tpu_torch.models.beam import beam_decode
from ecog2txt_tpu_torch.models.ctc import (
    LexiconTrie,
    _load_native,
    build_lexicon,
    ctc_loss,
    ctc_word_beam_search,
)
from ecog2txt_tpu_torch.models.seq2seq import (
    AuxHead,
    Seq2SeqConfig,
    decode_from_encoder,
    decoder_teacher_forcing,
    encode,
    greedy_decode,
    init_seq2seq,
    seq2seq_loss,
)
from ecog2txt_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerStream,
    conformer_encode,
    init_conformer,
)
from ecog2txt_tpu_torch.models import conformer as conformer_module
from ecog2txt_tpu_torch.ops import _build, attention_kernels, layernorm_kernels, lstm_kernels
from ecog2txt_tpu_torch.ops.lstm import init_lstm_params
from ecog2txt_tpu_torch.parallel import (
    gather_params_ep,
    make_mesh,
    sequence_parallel_encode,
    shard_params_ep,
    sp_pp_conformer_encode,
)
from ecog2txt_tpu_torch.parallel.expert import expert_mask
from ecog2txt_tpu_torch.parallel.launch import free_port, spawn
from ecog2txt_tpu_torch.parallel import mesh as mesh_module
from ecog2txt_tpu_torch.parallel.mesh import (
    Placement,
    gather_params_tp,
    make_dp_train_step,
    parallel_modes,
    reduce_gradients_,
)
from ecog2txt_tpu_torch.parallel.multihost import initialize_distributed
from ecog2txt_tpu_torch.plotting import DecodingResults, GridSearchResults, ResultsPlotter
from ecog2txt_tpu_torch.quantize import _column_major, int8_mm, quantize_conformer_params
from ecog2txt_tpu_torch.serve import (
    OnlinePredictor,
    RawVoltageSession,
    StreamingConformerSession,
    StreamingSession,
    StreamingSessionPool,
    _quantize_host_block,
    export_predictor,
    load_exported_predictor,
)
from ecog2txt_tpu_torch.tokenizers import read_vocab_file
from ecog2txt_tpu_torch.train import (
    CLIP_NORM,
    MultiSubjectTrainer,
    TrainState,
    make_optimizer,
    make_segment_runner,
)
from ecog2txt_tpu_torch.utils.flops import H100_BF16_PEAK_FLOPS, mfu, train_step_flops
from ecog2txt_tpu_torch.utils.introspect import _shape_tree
from ecog2txt_tpu_torch.utils.profiling import StepTimer
from ecog2txt_tpu_torch.utils.summaries import iter_events
from ecog2txt_tpu_torch.utils.tf1_import import tf1_variables_from_params

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

H, T_STEPS, IN_DIM = 400, 104, 800  # encoder layers 1-2 at T=1248 / 12
TOL = {
    torch.float32: dict(rtol=1e-4, atol=1e-5),
    torch.bfloat16: dict(rtol=5e-2, atol=2e-2),
}
LAUNCHES_PER_ENCODE = 6  # 3 layers x 2 directions
ENCODES_PER_CALL = 2  # greedy decode, then the teacher-forced probabilities
N_TRIALS, T_RAW, B_TRAIN, TRAIN_STEPS = 450, 1248, 256, 5  # training phase
PENALTIES = {"encoder_1_targets": 1.0, "decoder_targets": 1.0}


# the JAX package's headline conformer (bench.py:149-157) and its
# long-recording cell (bench.py:255-300)
HEADLINE_CONFORMER = dict(num_blocks=4, model_dim=384, num_heads=6, ffn_dim=1536,
                          conv_kernel=8, chunk_size=16, left_context=1)
LONG_B, LONG_T, LONG_IN = 16, 8192, 100
# the conformer demo trainer's widths
DEMO_CONFORMER = dict(num_blocks=2, model_dim=64, num_heads=4, ffn_dim=128,
                      conv_kernel=4, chunk_size=4, left_context=1, attention_impl="flash")
ATTN = attention_kernels
WRAPPERS = {
    "K1f": lstm_kernels.lstm_recurrence, "K1b": lstm_kernels.lstm_recurrence_bwd,
    "K2f": ATTN.banded_attention_fwd, "K2b-dq": ATTN.banded_attention_dq,
    "K2b-dkv": ATTN.banded_attention_dkv, "K3f": ATTN.fused_attention_fwd,
    "K4f": lstm_kernels.bilstm_grid_fwd, "K4b": lstm_kernels.bilstm_grid_bwd,
    "K5f": layernorm_kernels.layer_norm_fwd, "K5b": layernorm_kernels.layer_norm_bwd,
}
# the kernels with two bodies, chosen up front by dtype and shape (K5b: by
# the row's width); each wrapper counts its launches by body beside its
# plain count.  A count is one a wrapper call: a K3f tensor-core call and a
# K5b call are two CUDA launches each and count once.
BODIES = {"K1f": lstm_kernels.lstm_recurrence, "K1b": lstm_kernels.lstm_recurrence_bwd,
          "K2f": ATTN.banded_attention_fwd, "K4f": lstm_kernels.bilstm_grid_fwd,
          "K4b": lstm_kernels.bilstm_grid_bwd, "K2b-dq": ATTN.banded_attention_dq,
          "K2b-dkv": ATTN.banded_attention_dkv, "K3f": ATTN.fused_attention_fwd,
          "K5b": layernorm_kernels.layer_norm_bwd}
# LayerNorms per conformer block that run K5f/K5b: both FFNs, the
# attention's (except under 'fused', where K3f normalises inside), the
# conv module's and the block's output
LN_PER_BLOCK = {"flash": 5, "fused": 4}


class SmokeFailure(RuntimeError):
    pass


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0, by body too."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    for wrapper in BODIES.values():
        for body in wrapper.launches_by_body:
            wrapper.launches_by_body[body] = 0


def read_bodies() -> dict:
    return {name: dict(wrapper.launches_by_body) for name, wrapper in BODIES.items()}


def check_bodies(path: str, bodies: dict, kernel: str, body: str, n: int) -> None:
    """All ``n`` launches of ``kernel`` on ``path`` went through ``body``."""
    want = {b: (n if b == body else 0) for b in bodies[kernel]}
    check(bodies[kernel] == want,
          f"{path}: {kernel} launches by body {bodies[kernel]}, expected {want}")


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def check_counts(path: str, counts: dict, expected: dict) -> None:
    """Kernels named in ``expected`` launched exactly that often, every
    other kernel never."""
    want = {name: expected.get(name, 0) for name in WRAPPERS}
    check(counts == want, f"{path}: kernel launches {counts}, expected {want}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time (ms) a call of ``fn`` spends in the kernels of
    category ``kernel`` (``_category``), from ``torch.profiler`` over ``reps``
    calls after a warm-up: CUDA events around calls of a small kernel would
    also time the host's launch overhead between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and _category(ev.key) == kernel)
    check(total > 0, f"device_ms: no {kernel} kernel in the trace")
    return total / 1e3 / reps


def _device_in_turns(fns: dict, reps: int, order, kernel: str) -> dict:
    """``_in_turns`` with ``device_ms``: device time in the kernels of
    ``kernel`` of each of ``fns``, in the given order."""
    ms: dict = {name: [] for name in fns}
    for name in order:
        ms[name].append(device_ms(fns[name], reps, kernel))
    return {name: float(np.mean(v)) for name, v in ms.items()}


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict,
            normwise: bool = False):
    """Max abs / rel error; fails unless |got-want| <= atol + rtol|want|
    elementwise, or with ``normwise`` <= atol + rtol max|want| (for
    gradients that are sums over thousands of products taken in another
    order, whose elementwise error follows the sum's scale, not the
    element's)."""
    g, w = got.float(), want.float()
    check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    diff = (g - w).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max()) if diff.numel() else 0.0
    scale = w.abs().max() if normwise and w.numel() else w.abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * scale).all())
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite values")
    check(ok, f"{name}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
               f"beyond rtol {tol['rtol']} / atol {tol['atol']}")
    return max_abs, max_rel


# --------------------------------------------------------------------------
# 1. environment
# --------------------------------------------------------------------------


def environment() -> dict:
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1] if nvcc else '?'}")
    try:
        import triton

        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    # the reference products stay full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one nvcc per source, all started together; the phases wait for what
    # they use (wait_built), so the slowest source (K3f's) builds while the
    # LSTM kernels are checked
    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    pool = ThreadPoolExecutor(len(names))

    def build(name):
        _build.load_library(name)
        return time.perf_counter() - t0

    return {"t0": t0, "pool": pool, "builds": {n: pool.submit(build, n) for n in names}}


def wait_built(env: dict, names=None) -> None:
    """Wait until the named kernel libraries (every one by default) are
    built and loaded (a failed build raises here); with every one, record
    and print the build's wall time."""
    for name in names or env["builds"]:
        env["builds"][name].result()
    if names is None and "build_s" not in env:
        env["pool"].shutdown()
        env["build_s"] = max(f.result() for f in env["builds"].values())
        print(f"kernel build: {', '.join(env['builds'])} {env['build_s']:.2f} s (in parallel; "
              "the LSTM kernel checks ran meanwhile)")


# --------------------------------------------------------------------------
# 2. kernels
# --------------------------------------------------------------------------


def _recurrence_inputs(B, dtype, variant, reverse_time, seed, h=H, steps=T_STEPS):
    """Inputs of one recurrence of width ``h`` over ``steps`` steps; the
    input width is the full-width model's where ``h`` is its width, else
    that of a layer above a biLSTM of width ``h``."""
    in_dim = IN_DIM if h == H else 2 * h
    g = torch.Generator().manual_seed(seed)
    p = init_lstm_params(g, in_dim, h, device="cuda")
    xs = torch.randn((steps, B, in_dim), generator=g).cuda()
    xw = (xs @ p["wx"] + p["b"]).to(dtype).contiguous()
    wh = p["wh"].to(dtype).contiguous()
    zeros = torch.zeros((B, h), device="cuda")
    if variant == "serving":
        lengths = torch.full((B,), steps, dtype=torch.int32)
        mask, h0, c0 = torch.ones_like(zeros), zeros, zeros
    else:
        lengths = torch.randint(1, steps + 1, (B,), generator=g, dtype=torch.int32)
        lengths[0] = steps // 2 + 1
        mask = (torch.rand((B, h), generator=g) < 0.5).float().cuda() * 2.0
        if reverse_time:  # the reverse-time recurrence takes a zero state
            h0 = c0 = zeros
        else:
            h0 = (torch.randn((B, h), generator=g) * 0.5).cuda()
            c0 = (torch.randn((B, h), generator=g) * 0.5).cuda()
    return xw, wh, lengths.cuda(), h0, c0, mask


def _library_lstm(wh: torch.Tensor):
    """A one-layer ``torch.nn.LSTM`` (cuDNN) computing the same function
    on the same ``xw`` at equal lengths, unit mask and zero state: the
    input weight is the permutation (i, g, f, o) → (i, f, g, o), the +1
    folded into the forget-gate bias.  Timed as a yardstick only."""
    perm = torch.cat([
        torch.arange(0, H), torch.arange(2 * H, 3 * H),
        torch.arange(H, 2 * H), torch.arange(3 * H, 4 * H),
    ]).cuda()
    lstm = torch.nn.LSTM(4 * H, H).cuda().to(wh.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda")[perm])
        lstm.weight_hh_l0.copy_(wh.float()[:, perm].T)
        lstm.bias_ih_l0.zero_()
        lstm.bias_ih_l0[H:2 * H] = 1.0
        lstm.bias_hh_l0.zero_()
    return lstm


def _bound(B: int, dtype) -> tuple[float, str]:
    """Least time (ms) for one serving-shape launch: the larger of the
    products' FLOPs at the card's peak for the type and the bytes that
    must move (xw, wh, lengths, h0, c0, mask read once; h_seq, hT, cT
    written once) at the HBM rate."""
    es = torch.finfo(dtype).bits // 8
    flops = 2.0 * T_STEPS * B * H * 4 * H
    nbytes = (
        T_STEPS * B * 4 * H * es + H * 4 * H * es + 4 * B + 3 * B * H * 4
        + T_STEPS * B * H * es + 2 * B * H * 4
    )
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _cases(shapes):
    """Every (B, h, steps, dtype, reverse_time, variant) checked at
    ``shapes``: forward and reverse time, f32 and bf16, full lengths
    with a unit mask and zero state, and ragged lengths with a 0/2 mask
    and (forward time) a nonzero state."""
    for B, h, steps in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for reverse_time in (False, True):
                for variant in ("serving", "ragged_mask_state"):
                    yield B, h, steps, dtype, reverse_time, variant


def _case_name(B, h, steps, dtype, reverse_time, variant) -> str:
    return (f"B={B} H={h} T'={steps} {str(dtype)[6:]} "
            f"{'reverse' if reverse_time else 'forward'} {variant}")


def _in_turns(fns: dict, reps: int, order) -> dict:
    """Mean device time (ms) of each of ``fns`` timed in the given order
    (each name twice, e.g. a, b, c, c, b, a), so that a drift of the card
    between the calls falls on all of them alike."""
    ms: dict = {name: [] for name in fns}
    for name in order:
        ms[name].append(cuda_ms(fns[name], reps=reps))
    return {name: float(np.mean(v)) for name, v in ms.items()}


def _k1f_row_independence() -> None:
    """One row's outputs at B=1 equal the same row inside B=17 bit for bit
    (cluster body, bf16, ragged lengths and a 0/2 mask, both directions):
    each row of a tensor-core product is its own row of A times B."""
    for reverse_time in (False, True):
        args = _recurrence_inputs(17, torch.bfloat16, "ragged_mask_state", reverse_time, 77)
        one = tuple(a[:, :1] if a.dim() == 3 else a[:1] if a.shape[0] == 17 else a
                    for a in args)
        one = tuple(a.contiguous() for a in one)
        full = lstm_kernels.lstm_recurrence(*args, reverse_time=reverse_time, return_c_seq=True)
        alone = lstm_kernels.lstm_recurrence(*one, reverse_time=reverse_time, return_c_seq=True)
        torch.cuda.synchronize()
        same = all(torch.equal(f[:, :1] if f.dim() == 3 else f[:1], a)
                   for f, a in zip(full, alone))
        check(same, f"K1f cluster body: row 0 of B=17 differs from B=1 "
                    f"({'reverse' if reverse_time else 'forward'})")
    print("kernel lstm_recurrence_fwd: row 0 alone (B=1) == row 0 inside B=17 bit for bit, "
          "forward and reverse (cluster body)")


def _k1f_timings(B: int) -> dict:
    """K1f at the serving shape (bf16, full lengths, unit mask, zero state):
    the cluster body the wrapper plans in turns with the rows body (the old
    bf16 body) and cuDNN's ``nn.LSTM``; at B=256 the cluster body at 16 and
    32 rows a cluster in turns too; the plain version, the bound."""
    args = _recurrence_inputs(B, torch.bfloat16, "serving", False, 1000 + B)
    sms, smem_limit = lstm_kernels._device_limits(args[0].device)
    plan = lstm_kernels._plan_fwd(torch.bfloat16, B, H, args[0].device)
    check(plan["body"] == "cluster", f"K1f at B={B} H={H} bf16 plans {plan}")
    plan["resident_clusters"] = lstm_kernels._fwd_resident(0, H, plan["cluster_size"])
    rows = lstm_kernels._rows_for(B, H, sms, waves=2)
    lstm = _library_lstm(args[1])
    with torch.no_grad():
        lib_out, _ = lstm(args[0])
        t = _in_turns({
            "rows": lambda: lstm_kernels._launch(*args, False, False, rows),
            "cluster": lambda: lstm_kernels.lstm_recurrence(*args),
            "library": lambda: lstm(args[0]),
        }, 20, ("rows", "cluster", "library", "library", "cluster", "rows"))
    ours = lstm_kernels.lstm_recurrence(*args)[0]
    lib_err = float((lib_out.float() - ours.float()).abs().max())
    bound_ms, bound_by = _bound(B, torch.bfloat16)
    out = {"ms": t["cluster"], "ms_rows_body": t["rows"], "library_ms": t["library"],
           "plain_ms": cuda_ms(lambda: lstm_kernels.lstm_recurrence_reference(*args),
                               reps=3, warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by, "rows_per_block": rows, "plan": plan}
    if B == 256:
        cs = plan["cluster_size"]
        out["ms_by_rows_per_cluster"] = _in_turns({
            16: lambda: lstm_kernels._launch_cluster(*args, False, False, cs, 16),
            32: lambda: lstm_kernels._launch_cluster(*args, False, False, cs, 32),
        }, 20, (16, 32, 32, 16))
    print(f"timing lstm_recurrence_fwd B={B} T'={T_STEPS} H={H} bf16: kernel (cluster body, "
          f"{plan['clusters']} clusters of {plan['cluster_size']} CTAs x "
          f"{plan['rows_per_cluster']} rows, {plan['resident_clusters']} resident at once, "
          f"{plan['smem']} bytes of shared memory a CTA) {out['ms']:.4f} ms, in turns with the "
          f"rows body ({rows} rows a block) {out['ms_rows_body']:.4f} ms and cuDNN nn.LSTM "
          f"{out['library_ms']:.4f} ms [max abs diff to the kernel {lib_err:.3e}]; plain "
          f"{out['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
          + (f"; cluster body by rows a cluster, in turns: {out['ms_by_rows_per_cluster']}"
             if B == 256 else ""))
    return out


def _fwd_bodies_by_shape(shapes) -> dict:
    """K1f's and K4f's rows bodies in turns with their cluster bodies at
    every cluster size that fits (16 rows a cluster), bf16, full lengths,
    at each (B, H, T') of ``shapes``: the sizes the planner did not take
    beside the one it did, and how many clusters of each the card keeps
    resident at once."""
    out = {}
    sms, smem_limit = lstm_kernels._device_limits(torch.device("cuda"))
    for B, h, steps in shapes:
        sizes = lstm_kernels._fwd_cluster_sizes(h, smem_limit)
        order = ["rows", *(f"cs={c}" for c in sizes)]
        order += order[::-1]
        args = _recurrence_inputs(B, torch.bfloat16, "serving", False, 3000 + B + h, h, steps)
        xwf, xwb, whf, whb, lengths, maskf, maskb = _grid_inputs(
            B, torch.bfloat16, "serving", 3100 + B + h, h, steps)
        rows, grows = lstm_kernels._rows_for(B, h, sms, waves=2), lstm_kernels._rows_for(B, h, sms, 2)
        k1f = {"rows": lambda: lstm_kernels._launch(*args, False, False, rows)}
        # K4f's launches alone on inputs stacked once: at these sizes the
        # wrapper's stacking would cost the host more than the kernel
        st = lambda a, b: torch.stack([a, b])  # noqa: E731
        stacked = (st(xwf, xwb), st(whf, whb), lengths, st(maskf, maskb),
                   torch.empty((2, steps, B, h), dtype=torch.bfloat16, device="cuda"), None,
                   torch.empty((2, B, h), device="cuda"), torch.empty((2, B, h), device="cuda"))
        grid = lambda name, *tile: lstm_kernels._launch_grid(  # noqa: E731
            name, stacked, steps, B, h, torch.bfloat16, xwf.device, *tile)
        k4f = {"rows": lambda: grid("bilstm_grid_fwd", grows)}
        for c in sizes:
            k1f[f"cs={c}"] = lambda c=c: lstm_kernels._launch_cluster(*args, False, False, c, 16)
            k4f[f"cs={c}"] = lambda c=c: grid("bilstm_grid_fwd_cluster", c, 16)
        entry = {"resident_clusters": {c: lstm_kernels._fwd_resident(0, h, c) for c in sizes}}
        for name, fns, directions in (("K1f", k1f, 1), ("K4f", k4f, 2)):
            plan = lstm_kernels._plan_fwd(torch.bfloat16, B, h, args[0].device, directions)
            ms = _in_turns(fns, 10, order)
            taken = f"cs={plan['cluster_size']}"
            entry[name] = {"ms": ms, "planned": taken, "rows_per_cluster": plan["rows_per_cluster"]}
            print(f"timing {name} B={B} H={h} T'={steps} bf16, bodies in turns: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; planned {taken} x {plan['rows_per_cluster']} rows"
                  + (f" ({'no slower' if ms[taken] <= ms['rows'] else 'SLOWER'} than the rows "
                     "body)" if plan["rows_per_cluster"] == 16 else ""))
        print(f"resident clusters at H={h}: {entry['resident_clusters']}")
        out[f"B={B} H={h} T'={steps}"] = entry
    return out


def kernel_phase(extra_shapes) -> dict:
    """K1f against its plain version at the serving shapes (B in {1, 16,
    17, 256}) and at ``extra_shapes`` (B, H, T'): bf16 through the cluster
    body (bit-identical on repeat), f32 through the rows body; one row alone
    against the same row in a batch; then its timings at B=1 and 256."""
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # B=1 and B=17 pad the cluster body's 16-row tiles
    shapes = [(1, H, T_STEPS), (16, H, T_STEPS), (17, H, T_STEPS), (256, H, T_STEPS),
              *extra_shapes]
    for seed, (B, h, steps, dtype, reverse_time, variant) in enumerate(_cases(shapes), 1):
        args = _recurrence_inputs(B, dtype, variant, reverse_time, seed, h, steps)
        with_c = variant != "serving"
        before = read_bodies()["K1f"]
        got = lstm_kernels.lstm_recurrence(
            *args, reverse_time=reverse_time, return_c_seq=with_c
        )
        case = _case_name(B, h, steps, dtype, reverse_time, variant)
        body = "cluster" if dtype == torch.bfloat16 else "rows"
        check(read_bodies()["K1f"][body] == before[body] + 1,
              f"K1f {case}: launches by body {read_bodies()['K1f']}, expected the {body} body")
        if body == "cluster":
            again = lstm_kernels.lstm_recurrence(
                *args, reverse_time=reverse_time, return_c_seq=with_c
            )
            torch.cuda.synchronize()
            check(all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
                  f"K1f {case}: two launches on the same inputs differ")
        want = lstm_kernels.lstm_recurrence_reference(
            *args, reverse_time=reverse_time, return_c_seq=with_c
        )
        torch.cuda.synchronize()
        worst = (0.0, 0.0)
        for name, g, w in zip(("h_seq", "c_seq", "hT", "cT"), got, want):
            if w is None:
                continue
            a, r = compare(f"{case} {name}", g, w, TOL[dtype])
            worst = (max(worst[0], a), max(worst[1], r))
        errs[dtype] = max(errs[dtype], worst[0])
        print(f"kernel lstm_recurrence_fwd {case} ({body} body"
              f"{', bit-identical on repeat' if body == 'cluster' else ''}): max abs err "
              f"{worst[0]:.3e}, max rel err {worst[1]:.3e}")
    _k1f_row_independence()
    return {"errs": errs, "timings": {B: _k1f_timings(B) for B in (1, 256)}}


def _adjoint_inputs(B, dtype, variant, reverse_time, seed, h=H, steps=T_STEPS):
    """K1b's inputs from a real forward pass (the plain version), with
    nonzero upstream gradients dhseq, dhT and dcT."""
    xw, wh, lengths, h0, c0, mask = _recurrence_inputs(
        B, dtype, variant, reverse_time, seed, h, steps
    )
    h_seq, c_seq, _, _ = lstm_kernels.lstm_recurrence_reference(
        xw, wh, lengths, h0, c0, mask, reverse_time, return_c_seq=True
    )
    hprev = lstm_kernels._shifted(h_seq, h0, reverse_time)
    cprev = lstm_kernels._shifted(c_seq, c0, reverse_time)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dhseq = torch.randn(h_seq.shape, generator=g, device="cuda").to(dtype)
    dhT = torch.randn((B, h), generator=g, device="cuda")
    dcT = torch.randn((B, h), generator=g, device="cuda")
    return xw, wh, hprev, cprev, c_seq, lengths, mask, dhseq, dhT, dcT


def _bwd_bound(B: int, dtype) -> tuple[float, str]:
    """Least time (ms) for one training-shape K1b launch: both products
    per step (4 T' B H 4H FLOPs) at the card's peak for the type, or the
    bytes that must move (xw, hprev, cprev, cseq, dhseq, wh, lengths,
    mask, dhT, dcT read once; dgates, dh0, dc0 written once) at the HBM
    rate, whichever is larger."""
    es = torch.finfo(dtype).bits // 8
    flops = 4.0 * T_STEPS * B * H * 4 * H
    nbytes = (
        2 * T_STEPS * B * 4 * H * es + 4 * T_STEPS * B * H * es
        + H * 4 * H * es + 4 * B + 5 * B * H * 4
    )
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _library_lstm_bwd_ms(xw, wh, dhseq) -> float:
    """cuDNN ``nn.LSTM`` backward on the same xw and upstream gradient:
    (forward + backward) - forward, CUDA events.  It also computes the
    weight gradients (input and recurrent), which K1b leaves to a GEMM."""
    lstm = _library_lstm(wh)
    x = xw.detach().clone().requires_grad_()

    def fwd():
        lstm(x)

    def fwd_bwd():
        out, _ = lstm(x)
        out.backward(dhseq)

    with torch.enable_grad():
        both = cuda_ms(fwd_bwd, reps=20)
        fwd_ms = cuda_ms(fwd, reps=20)
    return both - fwd_ms


def kernel_bwd_phase(extra_shapes) -> dict:
    """K1b against its plain version at the full-width training shapes
    and at ``extra_shapes`` (B, H, T'), the autograd Function against
    autograd through the plain forward, and K1b's timings."""
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # B=1 and B=17 pad the cluster body's 16-row tiles, H=100 its unit slices
    shapes = [(16, H, T_STEPS), (B_TRAIN, H, T_STEPS), (1, H, T_STEPS), (17, H, T_STEPS),
              (17, 100, T_STEPS), *extra_shapes]
    for seed, (B, h, steps, dtype, reverse_time, variant) in enumerate(_cases(shapes), 101):
        args = _adjoint_inputs(B, dtype, variant, reverse_time, seed, h, steps)
        before = read_bodies()["K1b"]
        got = lstm_kernels.lstm_recurrence_bwd(*args, reverse_time=reverse_time)
        again = lstm_kernels.lstm_recurrence_bwd(*args, reverse_time=reverse_time)
        want = lstm_kernels.lstm_recurrence_bwd_reference(*args, reverse_time=reverse_time)
        torch.cuda.synchronize()
        case = _case_name(B, h, steps, dtype, reverse_time, variant)
        body = "cluster" if dtype == torch.bfloat16 else "rows"
        check(read_bodies()["K1b"][body] == before[body] + 2,
              f"K1b {case}: launches by body {read_bodies()['K1b']}, expected the {body} body")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K1b {case}: two launches on the same inputs differ")
        worst = (0.0, 0.0)
        for name, g, w in zip(("dgates", "dh0", "dc0"), got, want):
            a, r = compare(f"{case} {name}", g, w, TOL[dtype])
            worst = (max(worst[0], a), max(worst[1], r))
        errs[dtype] = max(errs[dtype], worst[0])
        print(f"kernel lstm_recurrence_bwd {case} ({body} body, bit-identical on repeat): "
              f"max abs err {worst[0]:.3e}, max rel err {worst[1]:.3e}")

    # the autograd Function (K1f forward, K1b backward) at f32; dwh sums
    # T'·B products in another order than autograd's per-step sums, so
    # gradients are held normwise
    grad_err = 0.0
    for reverse_time in (False, True):
        xw, wh, lengths, h0, c0, mask = _recurrence_inputs(
            16, torch.float32, "ragged_mask_state", reverse_time, 200 + reverse_time
        )
        w_out = torch.randn((H,), generator=torch.Generator().manual_seed(3)).cuda()

        def grads(fn):
            leaves = [a.detach().clone().requires_grad_() for a in (xw, wh, h0, c0)]
            out, hT, cT = fn(*leaves)
            ((out * w_out).sum() + 2.0 * hT.sum() + 0.5 * (cT ** 2).sum()).backward()
            return [a.grad for a in leaves]

        got = grads(lambda x, w, h, c: lstm_kernels.fused_lstm_recurrence(
            x, w, lengths, h, c, mask, reverse_time))

        def plain(x, w, h, c):
            h_seq, _, hT, cT = lstm_kernels.lstm_recurrence_reference(
                x, w, lengths, h, c, mask, reverse_time)
            return h_seq, hT, cT

        want = grads(plain)
        for name, g, w in zip(("xw", "wh", "h0", "c0"), got, want):
            a, _ = compare(f"Function grad {name} "
                           f"{'reverse' if reverse_time else 'forward'}", g, w,
                           TOL[torch.float32], normwise=True)
            grad_err = max(grad_err, a)
    print(f"autograd Function (K1f + K1b) vs autograd through the plain forward, "
          f"f32 B=16: max abs err {grad_err:.3e}")

    timings = {}
    sms, smem_limit = lstm_kernels._device_limits(torch.device("cuda"))
    resident = _build.load_library("lstm_bwd_cluster").lstm_recurrence_bwd_cluster_max_active
    resident.argtypes, resident.restype = [ctypes.c_int] * 3, ctypes.c_int
    for B in (16, 256):
        args = _adjoint_inputs(B, torch.bfloat16, "serving", False, 1000 + B)
        plan = lstm_kernels.plan_bwd_body(torch.bfloat16, B, H, sms, smem_limit)
        check(plan["body"] == "cluster", f"K1b at B={B} H={H} bf16 plans {plan}")
        rows = lstm_kernels._rows_for(B, H, sms)
        # the rows body (the previous bf16 body) in turns with the cluster body
        rows_ms, kernel_ms = [], []
        for _ in range(2):
            rows_ms.append(cuda_ms(lambda: lstm_kernels._launch_bwd(*args, False, rows), reps=10))
            kernel_ms.append(cuda_ms(lambda: lstm_kernels.lstm_recurrence_bwd(*args), reps=20))
        kernel_ms, rows_ms = float(np.mean(kernel_ms)), float(np.mean(rows_ms))
        plain_ms = cuda_ms(
            lambda: lstm_kernels.lstm_recurrence_bwd_reference(*args), reps=3, warmup=1
        )
        library_ms = _library_lstm_bwd_ms(args[0], args[1], args[7])
        bound_ms, bound_by = _bwd_bound(B, torch.bfloat16)
        # clusters the card keeps resident at once: more run in waves
        plan["resident_clusters"] = resident(B, H, plan["cluster_size"])
        timings[B] = {
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_rows_body": rows_ms,
            "rows_per_block": rows, "plan": plan,
        }
        print(f"timing lstm_recurrence_bwd B={B} T'={T_STEPS} H={H} bf16: "
              f"kernel (cluster body, {plan['clusters']} clusters of {plan['cluster_size']} "
              f"CTAs x {plan['rows_per_cluster']} rows, {plan['resident_clusters']} resident "
              f"at once, {plan['smem']} bytes of shared memory a CTA) {kernel_ms:.4f} ms, "
              f"rows body "
              f"({rows} rows a block) {rows_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"(cuDNN nn.LSTM backward, with weight gradients) {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"errs": errs, "grad_err": grad_err, "timings": timings}


# --------------------------------------------------------------------------
# 2b. the one-launch biLSTM grid (K4f, K4b) and LayerNorm (K5f, K5b)
# --------------------------------------------------------------------------


def _grid_inputs(B, dtype, variant, seed, h=H, steps=T_STEPS):
    """K4f's inputs: both directions' projections and weights from two
    recurrences of width ``h`` (zero state); full lengths and unit masks,
    or ragged lengths and 0/2 masks."""
    xwf, whf, lengths, _, _, maskf = _recurrence_inputs(B, dtype, variant, True, seed, h, steps)
    xwb, whb, _, _, _, maskb = _recurrence_inputs(B, dtype, variant, True, seed + 5000, h, steps)
    return xwf, xwb, whf, whb, lengths, maskf, maskb


def _grid_adjoint_inputs(B, dtype, variant, seed, h=H, steps=T_STEPS):
    """K4b's inputs from a real forward pass (the plain version), with
    nonzero upstream gradients for both directions' h_seq and the final
    states."""
    xwf, xwb, whf, whb, lengths, maskf, maskb = _grid_inputs(B, dtype, variant, seed, h, steps)
    hf, hb, cf, cb, _, _ = lstm_kernels.bilstm_grid_fwd_reference(
        xwf, xwb, whf, whb, lengths, maskf, maskb)
    zeros = torch.zeros((B, h), device="cuda")
    hpf, cpf = (lstm_kernels._shifted(s, zeros, False) for s in (hf, cf))
    hpb, cpb = (lstm_kernels._shifted(s, zeros, True) for s in (hb, cb))
    g = torch.Generator(device="cuda").manual_seed(seed)
    dhsf, dhsb = (torch.randn(hf.shape, generator=g, device="cuda").to(dtype) for _ in "fb")
    dhT, dcT = (torch.randn((2, B, h), generator=g, device="cuda") for _ in "hc")
    return (xwf, xwb, whf, whb, hpf, hpb, cpf, cpb, cf, cb, lengths, maskf, maskb,
            dhsf, dhsb, dhT, dcT)


def _library_bilstm(whf: torch.Tensor, whb: torch.Tensor):
    """A one-layer bidirectional ``torch.nn.LSTM`` (cuDNN) of the same
    width on a (T', B, 4H) input, each direction's weights set as in
    :func:`_library_lstm`: both chains in one call.  cuDNN feeds both
    directions the same input, where K4f takes one projection each, so
    it is a yardstick of time, not of values."""
    one_f, one_b = _library_lstm(whf), _library_lstm(whb)
    lstm = torch.nn.LSTM(4 * H, H, bidirectional=True).cuda().to(whf.dtype)
    with torch.no_grad():
        for suffix, one in (("", one_f), ("_reverse", one_b)):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(lstm, f"{name}_l0{suffix}").copy_(getattr(one, f"{name}_l0"))
    lstm.flatten_parameters()
    return lstm


def _two_k1b(args):
    """K4b's two chains as two K1b launches (the forward chain's adjoint,
    then the reverse chain's) on K4b's inputs: ``(dgf, dgb, dh0, dc0)``."""
    (xwf, xwb, whf, whb, hpf, hpb, cpf, cpb, csf, csb, lengths, maskf, maskb,
     dhsf, dhsb, dhT, dcT) = args
    dgf, dh0f, dc0f = lstm_kernels.lstm_recurrence_bwd(
        xwf, whf, hpf, cpf, csf, lengths, maskf, dhsf, dhT[0], dcT[0])
    dgb, dh0b, dc0b = lstm_kernels.lstm_recurrence_bwd(
        xwb, whb, hpb, cpb, csb, lengths, maskb, dhsb, dhT[1], dcT[1], True)
    return dgf, dgb, torch.stack([dh0f, dh0b]), torch.stack([dc0f, dc0b])


def _two_k1f(args):
    """K4f's two chains as two K1f launches (the forward chain, then the
    reverse chain, each from a zero state) on K4f's inputs, in K4f's order
    ``(hf, hb, cf, cb, hT, cT)``."""
    xwf, xwb, whf, whb, lengths, maskf, maskb = args
    zeros = torch.zeros(maskf.shape, device="cuda")
    hf, cf, hTf, cTf = lstm_kernels.lstm_recurrence(xwf, whf, lengths, zeros, zeros, maskf,
                                                    False, True)
    hb, cb, hTb, cTb = lstm_kernels.lstm_recurrence(xwb, whb, lengths, zeros, zeros, maskb,
                                                    True, True)
    return hf, hb, cf, cb, torch.stack([hTf, hTb]), torch.stack([cTf, cTb])


def _grid_case_check(kind, B, h, steps, dtype, variant, seed, errs):
    """One K4f or K4b case against its plain version.  Each also runs twice
    (the two launches bit-identical) and its body must be the one planned
    for the dtype (bf16: the cluster body, which must then equal two K1f /
    K1b cluster launches bit for bit: the same body per direction)."""
    case = f"B={B} H={h} T'={steps} {str(dtype)[6:]} {variant}"
    body = "cluster" if dtype == torch.bfloat16 else "rows"
    if kind == "K4f":
        args = _grid_inputs(B, dtype, variant, seed, h, steps)
        before = read_bodies()["K4f"]
        got = lstm_kernels.bilstm_grid_fwd(*args)
        again = lstm_kernels.bilstm_grid_fwd(*args)
        want = lstm_kernels.bilstm_grid_fwd_reference(*args)
        names = ("hf", "hb", "cf", "cb", "hT", "cT")
        torch.cuda.synchronize()
        check(read_bodies()["K4f"][body] == before[body] + 2,
              f"K4f {case}: launches by body {read_bodies()['K4f']}, expected the {body} body")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K4f {case}: two launches on the same inputs differ")
        if body == "cluster":
            check(all(torch.equal(a, b) for a, b in zip(got, _two_k1f(args))),
                  f"K4f {case}: the cluster body differs from two K1f launches")
        case += f" ({body} body, bit-identical on repeat"
        case += ", == two K1f launches)" if body == "cluster" else ")"
    else:
        args = _grid_adjoint_inputs(B, dtype, variant, seed, h, steps)
        before = read_bodies()["K4b"]
        got = lstm_kernels.bilstm_grid_bwd(*args)
        again = lstm_kernels.bilstm_grid_bwd(*args)
        want = lstm_kernels.bilstm_grid_bwd_reference(*args)
        names = ("dgf", "dgb", "dh0", "dc0")
        torch.cuda.synchronize()
        check(read_bodies()["K4b"][body] == before[body] + 2,
              f"K4b {case}: launches by body {read_bodies()['K4b']}, expected the {body} body")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K4b {case}: two launches on the same inputs differ")
        if body == "cluster":
            two = _two_k1b(args)
            check(all(torch.equal(a, b) for a, b in zip(got, two)),
                  f"K4b {case}: the cluster body differs from two K1b launches")
        case += f" ({body} body, bit-identical on repeat"
        case += ", == two K1b launches)" if body == "cluster" else ")"
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(names, got, want):
        a, _ = compare(f"{kind} {case} {name}", g, w, TOL[dtype])
        worst = max(worst, a)
    errs[kind][dtype] = max(errs[kind][dtype], worst)
    print(f"kernel {kind} {case}: max abs err {worst:.3e}")


def _grid_function_grads() -> float:
    """``fused_bilstm_grid`` (K4f + K4b + two GEMMs) against autograd
    through the plain forward at f32, B=16, ragged lengths and 0/2 masks;
    held normwise (``dwh`` sums T'·B products in another order)."""
    xwf, xwb, whf, whb, lengths, maskf, maskb = _grid_inputs(
        16, torch.float32, "ragged_mask_state", 210)
    w_out = torch.randn((2 * H,), generator=torch.Generator().manual_seed(4)).cuda()

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_() for a in (xwf, xwb, whf, whb)]
        out, hT, cT = fn(*leaves)
        ((out * w_out).sum() + 2.0 * hT.sum() + 0.5 * (cT ** 2).sum()).backward()
        return [a.grad for a in leaves]

    got = grads(lambda *a: lstm_kernels.fused_bilstm_grid(*a, lengths, maskf, maskb))

    def plain(xf, xb, wf, wb):
        hf, hb, _, _, hT, cT = lstm_kernels.bilstm_grid_fwd_reference(
            xf, xb, wf, wb, lengths, maskf, maskb, return_c_seq=False)
        return torch.cat([hf, hb], -1), torch.cat([hT[0], hT[1]], -1), torch.cat([cT[0], cT[1]], -1)

    want = grads(plain)
    err = 0.0
    for name, g, w in zip(("xwf", "xwb", "whf", "whb"), got, want):
        a, _ = compare(f"BiLSTMGrid grad {name}", g, w, TOL[torch.float32], normwise=True)
        err = max(err, a)
    print(f"autograd Function (K4f + K4b) vs autograd through the plain forward, f32 B=16: "
          f"max abs err {err:.3e}")
    return err


def _grid_timings(B: int) -> dict:
    """K4f at the serving shape and K4b at the training shape (bf16, full
    lengths, unit masks): CUDA-event times beside the plain versions, the
    bounds (twice K1f's and K1b's: two chains of the same work), the cuDNN
    bidirectional yardstick and the two K1f / K1b launches each replaces.
    K4f's cluster body runs in turns with its rows body and cuDNN, and at
    B=256 at 16 and 32 rows a cluster in turns too."""
    dtype = torch.bfloat16
    args = _grid_inputs(B, dtype, "serving", 1100 + B)
    xwf, xwb, whf, whb, lengths, maskf, maskb = args
    zeros = torch.zeros((B, H), device="cuda")
    sms, smem_limit = lstm_kernels._device_limits(xwf.device)
    plan = lstm_kernels._plan_fwd(dtype, B, H, xwf.device, directions=2)
    check(plan["body"] == "cluster", f"K4f at B={B} H={H} bf16 plans {plan}")
    plan["resident_clusters"] = lstm_kernels._fwd_resident(0, H, plan["cluster_size"])
    plan["waves"] = -(-plan["clusters"] // plan["resident_clusters"])
    rows = lstm_kernels._rows_for(B, H, sms, directions=2)
    lstm = _library_bilstm(whf, whb)
    grid_fwd = lstm_kernels._launch_grid_fwd
    with torch.no_grad():
        t = _in_turns({
            "rows": lambda: grid_fwd(*args, False, {"body": "rows", "rows_per_block": rows}),
            "cluster": lambda: lstm_kernels.bilstm_grid_fwd(*args, return_c_seq=False),
            "library": lambda: lstm(xwf),
        }, 20, ("rows", "cluster", "library", "library", "cluster", "rows"))
    fwd = {"ms": t["cluster"], "ms_rows_body": t["rows"], "library_ms": t["library"],
           "plain_ms": cuda_ms(lambda: lstm_kernels.bilstm_grid_fwd_reference(
               *args, return_c_seq=False), reps=3, warmup=1),
           "two_k1f_ms": cuda_ms(lambda: (
               lstm_kernels.lstm_recurrence(xwf, whf, lengths, zeros, zeros, maskf),
               lstm_kernels.lstm_recurrence(xwb, whb, lengths, zeros, zeros, maskb, True)), 20),
           "rows_per_block": rows, "plan": plan}
    if B == 256:
        fwd["ms_by_rows_per_cluster"] = _in_turns({
            r: (lambda r=r: grid_fwd(*args, False, {**plan, "rows_per_cluster": r}))
            for r in (16, 32)}, 20, (16, 32, 32, 16))
    bound, by = _bound(B, dtype)
    fwd.update(bound_ms=2 * bound, bound_by=by)
    bargs = _grid_adjoint_inputs(B, dtype, "serving", 1200 + B)
    bwd = {"plain_ms": cuda_ms(lambda: lstm_kernels.bilstm_grid_bwd_reference(*bargs),
                               reps=3, warmup=1)}
    bwd.update(_k4b_bodies_in_turns(bargs))
    bwd["two_k1b_ms"] = cuda_ms(lambda: _two_k1b(bargs), 20)
    x = xwf.detach().clone().requires_grad_()
    dy = torch.cat([bargs[13], bargs[14]], dim=-1)

    def lib_fwd_bwd():
        out, _ = lstm(x)
        out.backward(dy)

    with torch.enable_grad():
        both = cuda_ms(lib_fwd_bwd, 20)
        lib_fwd = cuda_ms(lambda: lstm(x), 20)
    bound, by = _bwd_bound(B, dtype)
    bwd.update(library_ms=both - lib_fwd, bound_ms=2 * bound, bound_by=by)
    for name, t in (("K4f", fwd), ("K4b", bwd)):
        print(f"timing {name} B={B} T'={T_STEPS} H={H} bf16: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library (cuDNN bidirectional nn.LSTM"
              f"{'' if name == 'K4f' else ' backward, with weight gradients'}) "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              + (f"two K1f launches {t['two_k1f_ms']:.4f} ms; cluster body "
                 f"({t['plan']['clusters']} clusters of {t['plan']['cluster_size']} CTAs x "
                 f"{t['plan']['rows_per_cluster']} rows, {t['plan']['resident_clusters']} "
                 f"resident at once: {t['plan']['waves']} waves) in turns with the rows body "
                 f"({t['rows_per_block']} rows a block) {t['ms_rows_body']:.4f} ms and cuDNN"
                 + (f"; cluster body by rows a cluster, in turns: "
                    f"{t['ms_by_rows_per_cluster']}" if B == 256 else "")
                 if name == "K4f" else
                 f"two K1b launches {t['two_k1b_ms']:.4f} ms; cluster body "
                 f"({t['plan']['clusters']} clusters of {t['plan']['cluster_size']} CTAs, "
                 f"{t['plan']['resident_clusters']} resident at once: {t['plan']['waves']} "
                 f"waves) launch alone {t['ms_launch_only']:.4f} ms in turns with the rows "
                 f"body ({t['rows_per_block']} rows a block) {t['ms_rows_body']:.4f} ms"))
    return {"K4f": fwd, "K4b": bwd}


def _k4b_bodies_in_turns(bargs) -> dict:
    """K4b's wrapper (the cluster body, with the wrapper's stacking of the
    two directions' inputs), then its cluster launch alone and the rows
    body (the previous bf16 body) on the same stacked inputs, in turns
    (rows, cluster, cluster, rows); the plan, with how many clusters the
    card keeps resident at once and so the waves."""
    (xwf, xwb, whf, whb, hpf, hpb, cpf, cpb, csf, csb, lengths, maskf, maskb,
     dhsf, dhsb, dhT, dcT) = bargs
    T, B, G = xwf.shape
    h = G // 4
    sms, smem_limit = lstm_kernels._device_limits(xwf.device)
    plan = lstm_kernels.plan_bwd_body(xwf.dtype, B, h, sms, smem_limit, directions=2)
    check(plan["body"] == "cluster", f"K4b at B={B} H={h} bf16 plans {plan}")
    resident = _build.load_library("bilstm_grid").bilstm_grid_bwd_cluster_max_active
    resident.argtypes, resident.restype = [ctypes.c_int] * 3, ctypes.c_int
    plan["resident_clusters"] = resident(B, h, plan["cluster_size"])
    check(plan["resident_clusters"] > 0, f"K4b residency query failed: {plan}")
    plan["waves"] = -(-plan["clusters"] // plan["resident_clusters"])
    st = lambda a, b: torch.stack([a, b])  # noqa: E731
    wh = st(whf, whb)
    outs = (torch.empty((2, T, B, G), dtype=xwf.dtype, device=xwf.device),
            torch.empty((2, B, h), device=xwf.device), torch.empty((2, B, h), device=xwf.device))
    seqs = (st(hpf, hpb), st(cpf, cpb), st(csf, csb), lengths, st(maskf, maskb), st(dhsf, dhsb),
            dhT, dcT, *outs)
    cluster = (st(xwf, xwb), wh, *seqs)
    rows_in = (cluster[0], wh, wh.transpose(1, 2).contiguous(), *seqs)
    rows = lstm_kernels._rows_for(B, h, sms, directions=2)
    ms = {"rows": [], "cluster": []}
    for which in ("rows", "cluster", "cluster", "rows"):
        ms[which].append(cuda_ms(
            (lambda: lstm_kernels._launch_grid("bilstm_grid_bwd", rows_in, T, B, h, xwf.dtype,
                                               xwf.device, rows)) if which == "rows" else
            (lambda: lstm_kernels._launch_grid("bilstm_grid_bwd_cluster", cluster, T, B, h,
                                               xwf.dtype, xwf.device, plan["cluster_size"])),
            reps=10))
    return {"ms": cuda_ms(lambda: lstm_kernels.bilstm_grid_bwd(*bargs), 20),
            "ms_launch_only": float(np.mean(ms["cluster"])),
            "ms_rows_body": float(np.mean(ms["rows"])), "rows_per_block": rows, "plan": plan}


def _ln_bounds(rows: int, D: int, dtype) -> dict:
    """Least time (ms) of K5f and K5b: bytes (K5f: x in, y out, g and b;
    K5b: x and dy in, dx out, g in, dg and db out) at the HBM rate, or
    their elementwise f32 operations (about 8 per element forward, 12
    backward) at the f32 peak, whichever is larger."""
    es = torch.finfo(dtype).bits // 8
    n = rows * D
    out = {}
    for name, nbytes, ops in (("K5f", 2 * n * es + 2 * D * 4, 8.0 * n),
                              ("K5b", 3 * n * es + 3 * D * 4, 12.0 * n)):
        t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS
        out[name] = (1e3 * max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes")
    return out


def _ln_inputs(rows, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, D), generator=g, device="cuda") * 3 + 1).to(dtype)
    dy = torch.randn((rows, D), generator=g, device="cuda").to(dtype)
    lng = 1 + 0.2 * torch.randn((D,), generator=g, device="cuda")
    lnb = 0.1 * torch.randn((D,), generator=g, device="cuda")
    return x, dy, lng, lnb


def _ln_timings(label: str, rows: int, D: int) -> dict:
    """K5f and K5b at one shape, bf16: device times (and CUDA-event times,
    host included) beside the plain versions, the bounds and
    ``F.layer_norm`` (forward; its backward as (forward+backward) -
    forward)."""
    F = torch.nn.functional
    dtype = torch.bfloat16
    x, dy, lng, lnb = _ln_inputs(rows, D, dtype, 77)
    LN = layernorm_kernels
    bounds = _ln_bounds(rows, D, dtype)
    vec = LN._vec_rows(x, dy)
    # K5b as the wrapper runs it (the registers body, then the sum of its
    # partials), in turns with the registers body alone and the columns body
    # alone (the previous body, timed without its sum as before): device
    # time from the profiler, since at the headline rows the host's launch
    # overhead is longer than the kernel; and the CUDA-event time of the
    # wrapper as before
    k5b_fns = {"wrapper": lambda: LN.layer_norm_bwd(x, dy, lng),
               "registers": lambda: LN._launch_k5b("registers", x, dy, lng, 1e-6, vec,
                                                   reduce=False),
               "columns": lambda: LN._launch_k5b("columns", x, dy, lng, 1e-6, vec,
                                                 reduce=False)}
    turns = ("columns", "registers", "wrapper", "wrapper", "registers", "columns")
    k5b = _device_in_turns(k5b_fns, 20, turns, "K5b")
    k5b_events = _in_turns(k5b_fns, 20, turns)
    # K5f and its library call by device time too, for the same reason
    k5f = lambda: LN.layer_norm_fwd(x, lng, lnb)  # noqa: E731
    t = {"K5f": {"ms": device_ms(k5f, 20, "K5f"), "event_ms_with_host": cuda_ms(k5f, 20),
                 "plain_ms": cuda_ms(lambda: LN.layer_norm_fwd_reference(x, lng, lnb), 5, 1)},
         "K5b": {"ms": k5b["wrapper"], "ms_registers_body_alone": k5b["registers"],
                 "ms_columns_body_alone": k5b["columns"],
                 "event_ms_with_host": k5b_events,
                 "plain_ms": cuda_ms(lambda: LN.layer_norm_bwd_reference(x, dy, lng), 5, 1)}}
    # the library call takes its affine parameters in the stream dtype
    gl, bl = lng.to(dtype), lnb.to(dtype)
    with torch.no_grad():
        lib = lambda: F.layer_norm(x, (D,), gl, bl, 1e-6)  # noqa: E731
        t["K5f"]["library_ms"] = device_ms(lib, 20, "other kernels")
        t["K5f"]["library_event_ms_with_host"] = cuda_ms(lib, 20)
    xl, gq, bq = (a.detach().clone().requires_grad_() for a in (x, gl, bl))

    def lib_fwd_bwd():
        for a in (xl, gq, bq):  # no accumulation into earlier calls' gradients
            a.grad = None
        F.layer_norm(xl, (D,), gq, bq, 1e-6).backward(dy)

    with torch.enable_grad():
        both = cuda_ms(lib_fwd_bwd, 20)
        lib_fwd = cuda_ms(lambda: F.layer_norm(xl, (D,), gq, bq, 1e-6), 20)
        # its device time too, as K5b's ms is (every kernel of the call is
        # PyTorch's, "other kernels" to _category)
        both_dev = device_ms(lib_fwd_bwd, 20, "other kernels")
        fwd_dev = device_ms(lambda: F.layer_norm(xl, (D,), gq, bq, 1e-6), 20, "other kernels")
    t["K5b"]["library_ms"] = both_dev - fwd_dev
    t["K5b"]["library_event_ms_with_host"] = both - lib_fwd
    for name in ("K5f", "K5b"):
        t[name]["bound_ms"], t[name]["bound_by"] = bounds[name]
        r = t[name]
        print(f"timing {name} {label} rows={rows} D={D} bf16: kernel {r['ms']:.4f} ms (device "
              f"time), plain {r['plain_ms']:.4f} ms, library (F.layer_norm"
              f"{'' if name == 'K5f' else ' backward'}, device time) {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; CUDA events around the calls (host included): kernel "
                 f"{r['event_ms_with_host']:.4f} ms, library "
                 f"{r['library_event_ms_with_host']:.4f} ms" if name == "K5f" else "")
              + (f"; kernel = device time of the registers body + the sum of its partials; in "
                 f"turns the registers body alone {r['ms_registers_body_alone']:.4f} ms, the "
                 f"columns body alone {r['ms_columns_body_alone']:.4f} ms; CUDA events around "
                 "the calls (host included): " + ", ".join(
                     f"{k} {v:.4f} ms" for k, v in r["event_ms_with_host"].items())
                 if name == "K5b" else ""))
    return t


def _ln_function_grads() -> float:
    """``layer_norm`` (K5f + K5b + one sum) against autograd through the
    plain forward, f32, (B=4, T'=37, D=384) with a nonlinear loss; held
    normwise (dg and db sum over every row in another order)."""
    x, _, lng, lnb = _ln_inputs(4 * 37, 384, torch.float32, 78)
    x = x.reshape(4, 37, 384)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_() for a in (x, lng, lnb)]
        fn(*leaves).sin().sum().backward()
        return [a.grad for a in leaves]

    got = grads(layernorm_kernels.layer_norm)
    want = grads(layernorm_kernels.layer_norm_fwd_reference)
    err = 0.0
    for name, g, w in zip(("x", "g", "b"), got, want):
        check(g.dtype == torch.float32, f"LayerNorm grad d{name}: {g.dtype}")
        a, _ = compare(f"LayerNorm grad d{name}", g, w, TOL[torch.float32], normwise=True)
        err = max(err, a)
    print(f"autograd Function (K5f + K5b) vs autograd through the plain forward, f32: "
          f"max abs err {err:.3e}")
    return err


def grid_and_layernorm_kernel_phase(demo_shapes) -> dict:
    """K4f and K4b against their plain versions at the full-width shapes
    (H=400, T'=104, B in {1, 16, 17, 256}; at H=100 too) and the demo
    trainer's own (B=16, H=64); K5f and K5b at the headline conformer rows
    (B=256 x T'=104, D=384), the long recording's (B=16 x T'=8192) and at
    D=64; f32 and
    bf16, ragged lengths and 0/2 masks or odd row counts; the two
    Functions' gradients; the timings."""
    errs = {k: {torch.float32: 0.0, torch.bfloat16: 0.0} for k in ("K4f", "K4b", "K5f", "K5b")}
    shapes = {
        # B=1 and 17 pad the cluster bodies' 16-row tiles, H=100 their unit slices
        "K4f": [(B, H, T_STEPS) for B in (1, 16, 17, 256)] + [(17, 100, T_STEPS)]
        + list(demo_shapes),
        "K4b": [(B, h, T_STEPS) for h in (H, 100) for B in (1, 16, 17, 256)] + list(demo_shapes),
    }
    seed = 500
    for kind in ("K4f", "K4b"):
        for B, h, steps in shapes[kind]:
            for dtype in (torch.float32, torch.bfloat16):
                for variant in ("serving", "ragged_mask_state"):
                    seed += 1
                    _grid_case_check(kind, B, h, steps, dtype, variant, seed, errs)
    grid_grad_err = _grid_function_grads()
    LN = layernorm_kernels
    for label, rows, D in (("headline", 256 * T_STEPS, 384), ("long", LONG_B * LONG_T, 384),
                           ("demo width", 16 * 24 + 5, 64), ("odd", 37, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            x, dy, lng, lnb = _ln_inputs(rows, D, dtype, seed)
            y = LN.layer_norm_fwd(x, lng, lnb)
            before = read_bodies()["K5b"]["registers"]
            dx, dg, db = LN.layer_norm_bwd(x, dy, lng)
            again = LN.layer_norm_bwd(x, dy, lng)
            torch.cuda.synchronize()
            check(read_bodies()["K5b"]["registers"] == before + 2,
                  f"K5b rows={rows} D={D} {dtype}: launches by body {read_bodies()['K5b']}, "
                  "expected the registers body")
            check(all(torch.equal(a, b) for a, b in zip((dx, dg, db), again)),
                  f"K5b rows={rows} D={D} {dtype}: two launches differ")
            ry = LN.layer_norm_fwd_reference(x, lng, lnb)
            rdx, rdg, rdb = LN.layer_norm_bwd_reference(x, dy, lng)
            case = f"{label} rows={rows} D={D} {str(dtype)[6:]}"
            a, _ = compare(f"K5f {case} y", y, ry, TOL[dtype])
            errs["K5f"][dtype] = max(errs["K5f"][dtype], a)
            worst = compare(f"K5b {case} dx", dx, rdx, TOL[dtype])[0]
            # dg and db: the kernel's sums of its per-block partials,
            # against one sum over every row: held normwise
            for name, g, w in (("dg", dg.sum(0), rdg.sum(0)), ("db", db.sum(0), rdb.sum(0))):
                check(g.dtype == torch.float32, f"K5b {case} {name}: {g.dtype}")
                worst = max(worst, compare(f"K5b {case} {name}", g, w, TOL[torch.float32],
                                           normwise=True)[0])
            errs["K5b"][dtype] = max(errs["K5b"][dtype], worst)
            print(f"kernels K5f/K5b {case}: max abs err {a:.3e} / {worst:.3e} (K5b registers "
                  "body, bit-identical on repeat)")
            del x, dy, y, dx, ry, rdx, again
    ln_grad_err = _ln_function_grads()
    timings = {B: _grid_timings(B) for B in (1, 256)}
    ln_timings = {"headline": _ln_timings("headline", 256 * T_STEPS, 384),
                  "long": _ln_timings("long", LONG_B * LONG_T, 384)}
    return {"errs": errs, "grid_grad_err": grid_grad_err, "ln_grad_err": ln_grad_err,
            "timings": timings, "ln_timings": ln_timings}


# --------------------------------------------------------------------------
# 3. serving: the main path
# --------------------------------------------------------------------------


def serving_config(dtype=torch.bfloat16, use_pallas_lstm=True) -> Seq2SeqConfig:
    return Seq2SeqConfig(
        vocab_size=1809, num_subjects=1, in_channels=469, conv_sizes=(100,),
        decimation_factor=12, rnn_sizes=(400, 400, 400), aux_proj_sizes=(225,),
        aux_heads=(AuxHead("encoder_1_targets", "categorical", 45),),
        dec_embedding_size=150, dec_rnn_sizes=(800,), max_dec_len=20,
        compute_dtype=dtype, use_pallas_lstm=use_pallas_lstm,
    )


def _check_response(out: dict, B: int, name: str) -> None:
    tokens, probs = out["tokens"], out["probabilities"]
    check(tokens.shape == (B, 20) and probs.shape == (B, 20),
          f"{name}: shapes {tokens.shape} {probs.shape}")
    check(bool(np.isfinite(probs).all()), f"{name}: non-finite probabilities")
    check(bool(((probs >= 0) & (probs <= 1)).all()), f"{name}: probabilities outside [0, 1]")
    check(bool(((tokens >= 0) & (tokens < 1809)).all()), f"{name}: token ids out of range")
    check(len(out["sequences"]) == B, f"{name}: {len(out['sequences'])} sequences")


def _encode_padded(params, config, x: np.ndarray):
    padded = np.zeros((1, 1248, 469), np.float32)
    padded[0, : len(x)] = x
    lengths = torch.tensor([len(x)], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        return encode(params, config, torch.from_numpy(padded).cuda(), lengths, 0)


def serving_phase() -> dict:
    config = serving_config()
    params = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
    targets = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 1809)]
    predictor = OnlinePredictor(params, config, targets, max_samples=1248, device="cuda")
    rng = np.random.default_rng(0)
    singles = [rng.standard_normal((n, 469), dtype=np.float32) for n in (1248, 1000, 600)]
    batch = rng.standard_normal((256, 1248, 469), dtype=np.float32)

    def timed(x):
        t0 = time.perf_counter()
        out = predictor(x)  # returns host arrays: the device work is done
        return out, time.perf_counter() - t0

    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    calls = 0
    out, warm_s = timed(singles[0])
    calls += 1
    latencies = []
    single_out = []
    for x in singles:
        out, dt = timed(x)
        calls += 1
        _check_response(out, 1, f"single {len(x)}")
        latencies.append(dt)
        single_out.append(out)
    out1, first_batch_s = timed(batch)
    out2, batch_s = timed(batch)
    calls += 2
    _check_response(out2, 256, "batch 256")
    check(np.array_equal(out1["tokens"], out2["tokens"]), "batch: tokens differ between runs")
    session = StreamingSession(predictor)
    for chunk in np.split(singles[1], [250, 380, 780]):
        session.push(chunk)
    streamed = session.decode()
    calls += 1
    counts = read_counts()
    bodies = read_bodies()
    launches = counts["K1f"]
    # ------------------------------------------------------------------
    expected = calls * ENCODES_PER_CALL * LAUNCHES_PER_ENCODE
    check_counts(f"biLSTM serving ({calls} predictor calls)", counts, {"K1f": expected})
    check_bodies("biLSTM serving (bf16)", bodies, "K1f", "cluster", expected)
    check(np.array_equal(streamed["tokens"], single_out[1]["tokens"]),
          "streaming: tokens differ from the whole utterance")
    check(np.allclose(streamed["probabilities"], single_out[1]["probabilities"],
                      rtol=1e-6, atol=1e-7),
          "streaming: probabilities differ from the whole utterance")
    check(streamed["sequences"] == single_out[1]["sequences"],
          "streaming: sequences differ from the whole utterance")
    print(f"serving: {calls} predictor calls, {launches} recurrence launches "
          f"({LAUNCHES_PER_ENCODE} per encode), K1f by body {bodies['K1f']}")
    print(f"serving latency B=1 (s): warm-up {warm_s:.4f}, "
          + ", ".join(f"{len(x)} samples {dt:.4f}" for x, dt in zip(singles, latencies)))
    print(f"serving batch B=256: first {first_batch_s:.4f} s, second {batch_s:.4f} s "
          f"= {256 / batch_s:.2f} sentences/s")
    print("streaming: 4 ragged chunks decode == whole utterance")

    # ---- correctness against the plain path ----
    plain = dataclasses.replace(config, use_pallas_lstm=False)
    enc_err = 0.0
    for x in singles:
        (ok, fk, _), (op, fp, _) = (
            _encode_padded(params, config, x), _encode_padded(params, plain, x)
        )
        for name, g, w in (("outputs", ok, op), ("h", fk[0], fp[0]), ("c", fk[1], fp[1])):
            a, _ = compare(f"bf16 encode {len(x)} {name}", g, w, TOL[torch.bfloat16])
            enc_err = max(enc_err, a)
    print(f"bf16 encoder, kernel vs plain path: max abs err {enc_err:.3e}")
    f32 = dataclasses.replace(config, compute_dtype=torch.float32)
    f32_plain = dataclasses.replace(f32, use_pallas_lstm=False)
    pk = OnlinePredictor(params, f32, targets, max_samples=1248, device="cuda")
    pp = OnlinePredictor(params, f32_plain, targets, max_samples=1248, device="cuda")
    f32_err = 0.0
    before = read_bodies()["K1f"]
    for x in singles:
        (ok, fk, _), (op, fp, _) = (
            _encode_padded(params, f32, x), _encode_padded(params, f32_plain, x)
        )
        for name, g, w in (("outputs", ok, op), ("h", fk[0], fp[0]), ("c", fk[1], fp[1])):
            a, _ = compare(f"f32 encode {len(x)} {name}", g, w, TOL[torch.float32])
            f32_err = max(f32_err, a)
        tk, tp = pk(x), pp(x)
        check(np.array_equal(tk["tokens"], tp["tokens"]),
              f"f32 tokens of {len(x)} samples: kernel path != plain path")
    _check_f32_rows_body("f32 serving", "K1f", before)
    print(f"f32 encoder, kernel vs plain path: max abs err {f32_err:.3e}; "
          "greedy tokens identical (K1f rows body)")
    profile_call("B=1", lambda: predictor(singles[0]))
    profile_call("B=256", lambda: predictor(batch))
    return {
        "launches": launches, "bodies": bodies, "calls": calls, "latency_s": latencies,
        "batch_s": batch_s, "enc_err_bf16": enc_err, "enc_err_f32": f32_err,
    }


_KERNEL_CATEGORIES = (
    ("lstm_recurrence_fwd", "K1f"), ("lstm_recurrence_bwd", "K1b"),
    ("banded_attention_fwd_kernel", "K2f"), ("banded_attention_fwd_tc_kernel", "K2f"),
    ("banded_attention_dq_kernel", "K2b-dq"), ("banded_attention_dq_tc_kernel", "K2b-dq"),
    ("banded_attention_dkv_kernel", "K2b-dkv"), ("banded_attention_dkv_tc_kernel", "K2b-dkv"),
    ("fused_attention_fwd_kernel", "K3f"), ("fused_attention_fwd_tc_kernel", "K3f"),
    ("fused_attention_prep_kernel", "K3f"),
    ("bilstm_grid_fwd_kernel", "K4f"), ("bilstm_grid_fwd_cluster_kernel", "K4f"),
    ("bilstm_grid_bwd_kernel", "K4b"),
    ("bilstm_grid_bwd_cluster_kernel", "K4b"),
    ("layer_norm_fwd_kernel", "K5f"), ("layer_norm_bwd_kernel", "K5b"),
    ("layer_norm_bwd_rows_kernel", "K5b"), ("layer_norm_bwd_sum_kernel", "K5b"),
)


def _category(kernel: str) -> str:
    for key, cat in _KERNEL_CATEGORIES:
        if key in kernel:
            return cat
    if "Memcpy" in kernel or "Memset" in kernel:
        return "memcpy"
    if any(k in kernel.lower() for k in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "GEMM"
    return "other kernels"


def profile_call(name: str, fn, need=("K1f",)) -> dict:
    """Where one warmed-up call's device time goes: ``fn`` under
    ``torch.profiler``, device time summed by kernel category, beside
    the call's wall time (the profiler adds host overhead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_cat: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            cat = _category(ev.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(by_cat.values())
    for cat in need:
        check(by_cat.get(cat, 0.0) > 0.0, f"profile {name}: no {cat} time in the trace")
    print(f"profile {name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f} %): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      sorted(by_cat.items(), key=lambda kv: -kv[1])))
    return {"wall_ms": wall_ms, "busy_ms": busy, **by_cat}


# --------------------------------------------------------------------------
# 4. training: the main path
# --------------------------------------------------------------------------


def _random_corpus(config: Seq2SeqConfig, n_trials: int = N_TRIALS, t_raw: int = T_RAW) -> dict:
    """A device-resident corpus of ``n_trials`` random trials of up to
    ``t_raw`` samples (seed 0) in the trainer's layout: one subject axis,
    ECoG in bf16, ragged lengths, EOS-terminated pad-padded decoder
    targets, frame-aligned aux labels."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    shape = (1, n_trials)
    enc = torch.randn(shape + (t_raw, config.in_channels), generator=g, device=dev)
    L = config.max_dec_len
    dec_len = torch.randint(4, L + 1, shape, generator=g, device=dev, dtype=torch.int32)
    dec = torch.randint(3, config.vocab_size, shape + (L,), generator=g, device=dev,
                        dtype=torch.int32)
    pos = torch.arange(L, device=dev)
    dec = torch.where(pos == dec_len[..., None] - 1, config.eos_id, dec)
    dec = torch.where(pos >= dec_len[..., None], config.pad_id, dec)
    return {
        "encoder_inputs": enc.to(torch.bfloat16),
        "encoder_lengths": torch.randint(t_raw // 2, t_raw + 1, shape, generator=g,
                                         device=dev, dtype=torch.int32),
        "decoder_targets": dec,
        "decoder_lengths": dec_len,
        "encoder_1_targets": torch.randint(0, 45, shape + (t_raw,), generator=g,
                                           device=dev, dtype=torch.int32),
    }


def _check_f32_rows_body(path: str, kernel: str, before: dict) -> None:
    """The f32 launches of ``kernel`` since ``before`` (its launches by
    body) all went through the rows body."""
    f32_bodies = {b: n - before[b] for b, n in read_bodies()[kernel].items()}
    check(f32_bodies["cluster"] == 0 and f32_bodies["rows"] > 0,
          f"{path}: {kernel} launches by body {f32_bodies}, expected the rows body")


def _f32_kernel_vs_plain(params, data, idx, kernel_path=True) -> float:
    """Loss and every gradient leaf of one f32 batch, the kernel path
    (``use_pallas_lstm=kernel_path``) against the plain path, both
    drawing the same dropout masks (same seed)."""
    batch = {k: v[0][torch.as_tensor(idx, device="cuda")] for k, v in data.items()}
    batch["subject_idx"] = 0
    out = {}
    before = read_bodies()
    for use_pallas in (kernel_path, False):
        cfg = serving_config(torch.float32, use_pallas_lstm=use_pallas)
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        gen = torch.Generator(device="cuda").manual_seed(7)
        loss, _ = seq2seq_loss(p, cfg, batch, gen, train=True, penalty_scales=PENALTIES)
        loss.backward()
        out[use_pallas] = (loss.detach(), [t.grad for t in tree_leaves(p)])
    (lk, gk), (lp, gp) = out[kernel_path], out[False]
    path = f"use_pallas_lstm={kernel_path!r}"
    for kernel in ("K4f", "K4b") if kernel_path == "bi_grid" else ("K1f", "K1b"):
        _check_f32_rows_body(f"f32 training, {path}", kernel, before[kernel])
    err, _ = compare(f"f32 training loss, {path} vs plain path", lk, lp, TOL[torch.float32])
    for i, (a, b) in enumerate(zip(gk, gp)):
        e, _ = compare(f"f32 gradient leaf {i}, {path} vs plain path", a, b,
                       TOL[torch.float32], normwise=True)
        err = max(err, e)
    print(f"f32 training step, {path} vs plain path: loss {float(lk):.6f} vs "
          f"{float(lp):.6f}; {len(gk)} gradient leaves; max abs err {err:.3e}")
    return err


def training_phase() -> dict:
    config = serving_config()  # bf16, kernels on, FF 0.1 / RNN 0.5 dropout
    params = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
    data = _random_corpus(config)
    state = TrainState(
        params, tree_map(lambda t: t.detach().clone(), params),
        make_optimizer(params, 1e-3), 0,
    )
    runner = make_segment_runner(config, PENALTIES, 0.99)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    subject = np.zeros((1,), np.int32)

    def step() -> float:
        nonlocal state
        idx = rng.permutation(N_TRIALS)[:B_TRAIN][None]
        state, metrics = runner(state, data, subject, idx, gen, 0)
        return float(metrics["loss_total"])  # waits for the step

    t0 = time.perf_counter()
    losses = [step()]
    first_s = time.perf_counter() - t0
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    bodies = read_bodies()
    fwd, bwd = counts["K1f"], counts["K1b"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # ------------------------------------------------------------------
    want = TRAIN_STEPS * LAUNCHES_PER_ENCODE
    check_counts(f"biLSTM training ({TRAIN_STEPS} steps)", counts, {"K1f": want, "K1b": want})
    check_bodies("biLSTM training (bf16)", bodies, "K1f", "cluster", want)
    check_bodies("biLSTM training (bf16)", bodies, "K1b", "cluster", want)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    ms = 1e3 * float(np.mean(step_s))
    print(f"training B={B_TRAIN} x {T_RAW} samples, bf16, dropout on: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; {fwd} K1f + {bwd} K1b launches in {TRAIN_STEPS} steps")
    print(f"training step: first {1e3 * first_s:.2f} ms, then "
          + ", ".join(f"{1e3 * x:.2f}" for x in step_s)
          + f" ms; mean {ms:.2f} ms = {B_TRAIN / (ms / 1e3):.2f} sentences/s; "
          f"peak device memory {peak_gib:.2f} GiB (corpus included)")
    prof = profile_call(f"training step B={B_TRAIN}", step, need=("K1f", "K1b"))
    f32_err = _f32_kernel_vs_plain(params, data, rng.permutation(N_TRIALS)[:B_TRAIN])
    return {"fwd": fwd, "bwd": bwd, "ms": ms, "losses": losses, "profile": prof,
            "f32_err": f32_err, "bodies": bodies}


# --------------------------------------------------------------------------
# 5. the trainer on the demo experiment: a main path
# --------------------------------------------------------------------------


def demo_trainer(root: str) -> MultiSubjectTrainer:
    """The trainer of the synthetic demo experiment at its own widths,
    bf16, kernels on, dropout on."""
    manifest = make_demo_experiment(
        f"{root}/exp", subject_ids=(1,), N_epochs=40, FF_dropout=0.1,
        RNN_dropout=0.5,
    )
    return MultiSubjectTrainer(
        manifest, [1], VERBOSE=False, device="cuda",
        SN_kwargs={"compute_dtype": "bfloat16", "use_pallas_lstm": True,
                   "batch_size": 16, "learning_rate": 3e-3, "max_dec_len": 10},
    )


def trainer_kernel_shapes(trainer: MultiSubjectTrainer) -> list[tuple[int, int, int]]:
    """The (B, H, T') at which the trainer's steps launch K1f and K1b:
    every step takes ``batch_size`` trials padded to the partition's
    length, decimated by the conv stack."""
    cfg = trainer.net_config
    T_pad = trainer.packed_dataset("training").encoder_inputs.shape[2]
    steps = T_pad // cfg.decimation_factor
    return [(trainer.batch_size, h, steps) for h in sorted(set(cfg.rnn_sizes))]


def trainer_phase(trainer: MultiSubjectTrainer) -> dict:
    counts = trainer.packed_dataset("training").num_trials
    steps = trainer.N_epochs * sum(-(-int(n) // trainer.batch_size) for n in counts if n)
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.parallel_transfer_learn()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    bodies = read_bodies()
    fwd, bwd = counts["K1f"], counts["K1b"]
    # ------------------------------------------------------------------
    check(all(v == 0 for k, v in counts.items() if k not in ("K1f", "K1b")),
          f"trainer: launches {counts}")
    check_bodies("trainer (bf16)", bodies, "K1f", "cluster", fwd)
    check_bodies("trainer (bf16)", bodies, "K1b", "cluster", bwd)
    per_step = 2 * len(trainer.net_config.rnn_sizes)
    check(bwd == steps * per_step,
          f"trainer: K1b launched {bwd} times in {steps} steps; expected "
          f"{steps * per_step}")
    check(fwd >= steps * per_step, f"trainer: K1f launched {fwd} times")
    wers = [snap["training"]["word_error_rate"] for snap in history.values()]
    check(all(np.isfinite(wers)) and wers[-1] < wers[0],
          f"trainer: training WER did not fall: {wers}")
    predictor = OnlinePredictor.from_trainer(trainer)
    val = trainer.packed_dataset("validation")
    x = val.encoder_inputs[0, 0, : int(val.encoder_lengths[0, 0])]
    out = predictor(x)
    tokens = out["tokens"]
    check(tokens.shape == (1, trainer.net_config.max_dec_len)
          and bool(((tokens >= 0) & (tokens < trainer.net_config.vocab_size)).all())
          and bool(np.isfinite(out["probabilities"]).all()),
          f"trainer: served tokens {tokens}")
    print(f"trainer (demo experiment, bf16, kernels on): {steps} steps in "
          f"{fit_s:.2f} s with 4 assessments; training WER by assessment "
          + ", ".join(f"{w:.3f}" for w in wers)
          + f"; K1b {bwd} launches ({per_step} per step), K1f {fwd}")
    print(f"served validation trial 0: {out['sequences'][0]!r} "
          f"(reference {' '.join(val.references[0][0])!r})")
    return {"wers": wers, "steps": steps, "fwd": fwd, "bwd": bwd, "fit_s": fit_s,
            "bodies": bodies}


# --------------------------------------------------------------------------
# 5b. biLSTM serving and training under 'bi_grid': main paths
# --------------------------------------------------------------------------


def grid_serving_phase() -> dict:
    """The serving model of phase 3 under ``use_pallas_lstm='bi_grid'``:
    B=1 requests, a B=256 batch and a 4-chunk ``StreamingSession``, with
    3 K4f launches per encode and no other kernel; at f32 the encoder
    and the greedy tokens against the plain path."""
    config = serving_config(use_pallas_lstm="bi_grid")
    params = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
    targets = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 1809)]
    predictor = OnlinePredictor(params, config, targets, max_samples=1248, device="cuda")
    rng = np.random.default_rng(0)
    singles = [rng.standard_normal((n, 469), dtype=np.float32) for n in (1248, 1000, 600)]
    batch = rng.standard_normal((256, 1248, 469), dtype=np.float32)
    layers = len(config.rnn_sizes)
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    predictor(singles[0])  # warm-up
    calls = 1
    latencies, outs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        out = predictor(singles[0])
        latencies.append(time.perf_counter() - t0)
        outs.append(out)
        calls += 1
    single_1000 = predictor(singles[1])
    b1 = predictor(batch)
    t0 = time.perf_counter()
    b2 = predictor(batch)
    batch_s = time.perf_counter() - t0
    calls += 3
    session = StreamingSession(predictor)
    for chunk in np.split(singles[1], [250, 380, 780]):
        session.push(chunk)
    streamed = session.decode()
    calls += 1
    counts = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    check_counts("biLSTM 'bi_grid' serving", counts,
                 {"K4f": calls * ENCODES_PER_CALL * layers})
    check_bodies("biLSTM 'bi_grid' serving (bf16)", bodies, "K4f", "cluster",
                 calls * ENCODES_PER_CALL * layers)
    _check_response(outs[-1], 1, "'bi_grid' single")
    _check_response(b2, 256, "'bi_grid' batch")
    check(np.array_equal(b1["tokens"], b2["tokens"]), "'bi_grid' batch: tokens differ")
    check(np.array_equal(streamed["tokens"], single_1000["tokens"])
          and streamed["sequences"] == single_1000["sequences"],
          "'bi_grid' streaming: tokens differ from the whole utterance")
    latency = float(np.median(latencies))
    print(f"biLSTM 'bi_grid' serving: {calls} predictor calls, {counts['K4f']} K4f launches "
          f"({ENCODES_PER_CALL * layers} per request), 0 of every other kernel; B=1 1248 "
          "samples " + ", ".join(f"{1e3 * x:.2f}" for x in latencies)
          + f" ms (median {1e3 * latency:.2f}); B=256 {1e3 * batch_s:.2f} ms = "
          f"{256 / batch_s:.2f} sentences/s; streamed 4 chunks == whole utterance")
    f32 = serving_config(torch.float32, use_pallas_lstm="bi_grid")
    f32_plain = serving_config(torch.float32, use_pallas_lstm=False)
    pk = OnlinePredictor(params, f32, targets, max_samples=1248, device="cuda")
    pp = OnlinePredictor(params, f32_plain, targets, max_samples=1248, device="cuda")
    f32_err = 0.0
    before = read_bodies()["K4f"]
    for x in singles:
        (ok, fk, _), (op, fp, _) = (_encode_padded(params, f32, x),
                                    _encode_padded(params, f32_plain, x))
        for name, g, w in (("outputs", ok, op), ("h", fk[0], fp[0]), ("c", fk[1], fp[1])):
            a, _ = compare(f"'bi_grid' f32 encode {len(x)} {name}", g, w, TOL[torch.float32])
            f32_err = max(f32_err, a)
        check(np.array_equal(pk(x)["tokens"], pp(x)["tokens"]),
              f"'bi_grid' f32 tokens of {len(x)} samples: kernel path != plain path")
    _check_f32_rows_body("'bi_grid' f32 serving", "K4f", before)
    print(f"'bi_grid' f32 encoder vs plain path: max abs err {f32_err:.3e}; greedy tokens "
          "identical (K4f rows body)")
    prof = profile_call("'bi_grid' B=1", lambda: predictor(singles[0]), need=("K4f",))
    return {"counts": counts, "bodies": bodies, "calls": calls, "latency_s": latency,
            "latencies_s": latencies, "batch_s": batch_s, "enc_err_f32": f32_err,
            "profile_b1": prof}


def grid_training_phase() -> dict:
    """Phase 4's training under ``use_pallas_lstm='bi_grid'``: B=256,
    dropout on, TRAIN_STEPS segment-runner steps with 3 K4f and 3 K4b
    launches per step and no K1f/K1b; a falling loss; at f32 the loss and
    every gradient leaf against the plain path with the same masks."""
    config = serving_config(use_pallas_lstm="bi_grid")
    params = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
    data = _random_corpus(config)
    state = TrainState(params, tree_map(lambda t: t.detach().clone(), params),
                       make_optimizer(params, 1e-3), 0)
    runner = make_segment_runner(config, PENALTIES, 0.99)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    subject = np.zeros((1,), np.int32)

    def step() -> float:
        nonlocal state
        idx = rng.permutation(N_TRIALS)[:B_TRAIN][None]
        state, metrics = runner(state, data, subject, idx, gen, 0)
        return float(metrics["loss_total"])  # waits for the step

    losses = [step()]
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    want = TRAIN_STEPS * len(config.rnn_sizes)
    check_counts("biLSTM 'bi_grid' training", counts, {"K4f": want, "K4b": want})
    check_bodies("biLSTM 'bi_grid' training (bf16)", bodies, "K4f", "cluster", want)
    check_bodies("biLSTM 'bi_grid' training (bf16)", bodies, "K4b", "cluster", want)
    check(all(np.isfinite(losses)), f"'bi_grid' training: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"'bi_grid' training loss did not fall: {losses}")
    ms = 1e3 * float(np.mean(step_s))
    print(f"biLSTM 'bi_grid' training B={B_TRAIN} x {T_RAW} samples, bf16, dropout on: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; {counts['K4f']} K4f + {counts['K4b']} K4b launches in {TRAIN_STEPS} steps "
          f"(K4f by body {bodies['K4f']}, K4b {bodies['K4b']}); step "
          + ", ".join(f"{1e3 * x:.2f}" for x in step_s)
          + f" ms, mean {ms:.2f} ms = {B_TRAIN / (ms / 1e3):.2f} sentences/s")
    prof = profile_call(f"'bi_grid' training step B={B_TRAIN}", step, need=("K4f", "K4b"))
    f32_err = _f32_kernel_vs_plain(params, data, rng.permutation(N_TRIALS)[:B_TRAIN],
                                   kernel_path="bi_grid")
    return {"counts": counts, "bodies": bodies, "ms": ms, "losses": losses, "profile": prof,
            "f32_err": f32_err}


# --------------------------------------------------------------------------
# 6. the attention kernels
# --------------------------------------------------------------------------


def _attention_case(B, T, D, H, C, L, offset, dtype, ragged, seed):
    """Inputs of one banded-attention case: q, k, v, an upstream gradient
    and a pre-LayerNorm x, each (B, T1, D) with T1 a multiple of QB; the
    K3f weights; lengths full (offset + T) or ragged (the first row ends
    5 steps early, inside a chunk); the (B, T1, 1) valid-row mask."""
    QB = ATTN._pick_query_rows(C, L, None)
    T1 = -(-T // QB) * QB
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    q, k, v, gout, x = (rand(B, T1, D).to(dtype) for _ in range(5))
    if ragged:
        lengths = torch.randint(max(T // 2, 1), T + 1, (B,), generator=g, device="cuda")
        lengths[0] = T - 5
    else:
        lengths = torch.full((B,), T, device="cuda")
    lengths = (lengths + offset).to(torch.int32)
    pos = torch.arange(T1, device="cuda") + offset
    valid = ((torch.arange(T1, device="cuda")[None] < T) & (pos[None] >= 0)
             & (pos[None] < lengths[:, None]))[..., None]
    wqkv = rand(D, 3 * D) / D ** 0.5
    ln_g, ln_b = 1.0 + 0.1 * rand(D), 0.1 * rand(D)
    return dict(q=q, k=k, v=v, g=gout, x=x, lengths=lengths, valid=valid, QB=QB, T1=T1,
                args=(offset, lengths, C, L, T, QB, H),
                xw=ATTN._split_rot_weights(wqkv, H, dtype), ln_g=ln_g, ln_b=ln_b)


def _check_attention_case(case: str, c: dict, dtype, errs: dict) -> None:
    """K2f, K2b-dq, K2b-dkv and K3f against their plain versions on one
    case: forward outputs on valid rows (finite everywhere), backward
    outputs on every row."""
    tol = TOL[dtype]
    valid, args = c["valid"], c["args"]
    masked = lambda a: torch.where(valid, a.float(), 0.0)  # noqa: E731

    def hold(kernel, name, got, want, rows=True, t=tol):
        check(bool(torch.isfinite(got).all()), f"{case} {kernel} {name}: non-finite values")
        a, _ = compare(f"{case} {kernel} {name}", masked(got) if rows else got,
                       masked(want) if rows else want, t)
        errs[kernel][dtype] = max(errs[kernel][dtype], a)

    before = read_bodies()["K2f"]
    out, lse = ATTN.banded_attention_fwd(c["q"], c["k"], c["v"], *args)
    torch.cuda.synchronize()
    body = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    check(read_bodies()["K2f"][body] == before[body] + 1,
          f"{case} K2f: launches by body {read_bodies()['K2f']}, expected the {body} body")
    r_out, r_lse = ATTN.banded_attention_fwd_reference(c["q"], c["k"], c["v"], *args)
    hold("K2f", "out", out, r_out)
    hold("K2f", "lse", lse, r_lse, t=TOL[torch.float32])
    bwd = (c["q"], c["k"], c["v"], c["g"], r_lse, ATTN._delta(c["g"], r_out, args[-1]), *args)
    before = read_bodies()
    dq = ATTN.banded_attention_dq(*bwd)
    dk, dv = ATTN.banded_attention_dkv(*bwd)
    torch.cuda.synchronize()
    for k in ("K2b-dq", "K2b-dkv"):
        check(read_bodies()[k][body] == before[k][body] + 1,
              f"{case} {k}: launches by body {read_bodies()[k]}, expected the {body} body")
    hold("K2b-dq", "dq", dq, ATTN.banded_attention_dq_reference(*bwd), rows=False)
    r_dk, r_dv = ATTN.banded_attention_dkv_reference(*bwd)
    hold("K2b-dkv", "dk", dk, r_dk, rows=False)
    hold("K2b-dkv", "dv", dv, r_dv, rows=False)
    fused = (c["x"], c["xw"], c["ln_g"], c["ln_b"], *args)
    before = read_bodies()["K3f"][body]
    got = ATTN.fused_attention_fwd(*fused, True)
    (unsaved,) = ATTN.fused_attention_fwd(*fused, False)
    torch.cuda.synchronize()
    check(read_bodies()["K3f"][body] == before + 2,
          f"{case} K3f: launches by body {read_bodies()['K3f']}, expected the {body} body")
    want = ATTN.fused_attention_fwd_reference(*fused, True)
    for name, a, b in zip(("out", "q", "k", "v", "lse"), got, want):
        hold("K3f", name, a, b, rows=name in ("out", "lse"),
             t=TOL[torch.float32] if name == "lse" and dtype == torch.float32 else tol)
    check(torch.equal(unsaved, got[0]), f"{case} K3f: out without residuals differs")


def _check_fused_wide_head(Dh: int, dtype, seed: int) -> float:
    """K3f at a head dim above 256 (one head of width ``Dh``) at the query
    block and body ``fused_attention_layer`` plans on the card (bf16: the
    tensor-core body; f32: the CUDA-core body, whose projections take two
    head columns a thread, with the streamed tile width its block fits),
    B=16, T'=104, ragged lengths, against its plain version; the planned
    body must launch.  Returns the largest error."""
    B, T, C, L = 16, 104, 16, 1
    QB, body = ATTN.plan_fused_layer(dtype, B, T, 1, 128, C, L, Dh,
                                     ATTN._smem_limit("cuda"), ATTN._sm_count("cuda"))
    want_body = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    check(body == want_body, f"K3f head dim {Dh} {dtype}: planned the {body} body")
    tile = ATTN._fused_tile(QB, QB + L * C, Dh, ATTN._smem_limit("cuda"))
    T1 = -(-T // QB) * QB
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, T1, Dh), generator=g, device="cuda").to(dtype)
    xw = ATTN._split_rot_weights(
        torch.randn((Dh, 3 * Dh), generator=g, device="cuda") / Dh ** 0.5, 1, dtype)
    ln_g = 1.0 + 0.1 * torch.randn((Dh,), generator=g, device="cuda")
    ln_b = 0.1 * torch.randn((Dh,), generator=g, device="cuda")
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device="cuda").to(torch.int32)
    valid = (torch.arange(T1, device="cuda")[None] < lengths[:, None])[..., None]
    args = (0, lengths, C, L, T, QB, 1)
    before = read_bodies()["K3f"][body]
    got = ATTN.fused_attention_fwd(x, xw, ln_g, ln_b, *args, True)
    torch.cuda.synchronize()
    check(read_bodies()["K3f"][body] == before + 1,
          f"K3f head dim {Dh}: launches by body {read_bodies()['K3f']}, expected {body}")
    want = ATTN.fused_attention_fwd_reference(x, xw, ln_g, ln_b, *args, True)
    err = 0.0
    for name, a, b in zip(("out", "q", "k", "v", "lse"), got, want):
        if name in ("out", "lse"):
            a, b = torch.where(valid, a.float(), 0.0), torch.where(valid, b.float(), 0.0)
        tol = TOL[torch.float32] if name == "lse" and dtype == torch.float32 else TOL[dtype]
        e, _ = compare(f"K3f head dim {Dh} {str(dtype)[6:]} {name}", a, b, tol)
        err = max(err, e)
    how = "64-column tiles on the tensor cores" if body == "tensor_core" else (
        f"{tile}-column streamed tiles")
    print(f"attention kernels K3f head dim {Dh} (one head, query block {QB}, {body} body, "
          f"{how}) {str(dtype)[6:]}: max abs err {err:.3e}")
    return err


def _check_flash_wide_head(dtype, seed: int) -> float:
    """``banded_flash_attention`` at head dim 256 (one head: ``model_dim=
    256, num_heads=1``), B=2, T'=104, ragged lengths, at the query block
    it plans on the card: K2f, K2b-dq and K2b-dkv launch in the body of
    the dtype (bf16 tensor cores, f32 CUDA cores) and match their plain
    versions at that block (forward on valid rows; the kernels' gradients
    on the plain forward's lse and delta elementwise; the Function's
    gradients against autograd through the plain forward, normwise).
    Returns the largest error."""
    B, T, Dh, C, L = 2, 104, 256, 16, 1
    QB = ATTN.plan_banded_query_rows(dtype, 128, C, L, Dh, ATTN._smem_limit("cuda"))
    check(QB < 128, f"head dim {Dh} {dtype}: planned query block {QB}")
    T1 = -(-T // QB) * QB
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, cot = (torch.randn((B, T, 1, Dh), generator=g, device="cuda").to(dtype)
                    for _ in range(4))
    lengths = torch.tensor([T, 61], dtype=torch.int32, device="cuda")
    valid = (torch.arange(T, device="cuda")[None] < lengths[:, None])[..., None, None]
    cot = torch.where(valid, cot, 0.0).to(dtype)
    body = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    before = read_bodies()
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = ATTN.banded_flash_attention(*leaves, 0, lengths, chunk_size=C, left_context=L)
    (out.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    for kernel in ("K2f", "K2b-dq", "K2b-dkv"):
        check(read_bodies()[kernel][body] == before[kernel][body] + 1,
              f"head dim {Dh} {dtype}: {kernel} launches by body {read_bodies()[kernel]}")
    tol = TOL[dtype]
    pad = lambda a: torch.nn.functional.pad(a.reshape(B, T, Dh), (0, 0, 0, T1 - T))  # noqa: E731
    q3, k3, v3, g3 = (pad(a).contiguous() for a in (q, k, v, cot))
    args = (0, lengths, C, L, T, QB, 1)
    r_out, r_lse = ATTN.banded_attention_fwd_reference(q3, k3, v3, *args)
    name = f"flash head dim {Dh} {str(dtype)[6:]} (query block {QB})"
    err, _ = compare(f"{name} out", torch.where(valid, out.detach().float(), 0.0),
                     torch.where(valid, r_out[:, :T].reshape(B, T, 1, Dh).float(), 0.0), tol)
    bwd = (q3, k3, v3, g3, r_lse, ATTN._delta(g3, r_out, 1), *args)
    dq = ATTN.banded_attention_dq(*bwd)
    dk, dv = ATTN.banded_attention_dkv(*bwd)
    r_dk, r_dv = ATTN.banded_attention_dkv_reference(*bwd)
    for label, a, b in (("dq", dq, ATTN.banded_attention_dq_reference(*bwd)),
                        ("dk", dk, r_dk), ("dv", dv, r_dv)):
        err = max(err, compare(f"{name} kernel {label}", a, b, tol)[0])
    plain = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    p_out, _ = ATTN.banded_attention_fwd_reference(*(pad(a) for a in plain), *args)
    (p_out[:, :T].reshape(B, T, 1, Dh).float() * cot.float()).sum().backward()
    for label, a, b in zip(("dq", "dk", "dv"), leaves, plain):
        err = max(err, compare(f"{name} Function grad {label}", a.grad, b.grad, tol,
                               normwise=True)[0])
    print(f"banded_flash_attention head dim {Dh} (one head) {str(dtype)[6:]}: planned query "
          f"block {QB}, {body} bodies, forward and backward match the plain versions: max abs "
          f"err {err:.3e}")
    return err


def _function_grads() -> float:
    """The autograd Functions (K2f + K2b; K3f + K2b + plain products)
    against autograd through the plain forward, f32, B=2, T'=300 (three
    query blocks and a trailing pad), ragged lengths, a cotangent on
    valid rows.  Held normwise: weight gradients sum B·T' products in
    another order."""
    B, T, D, H, C, L = 2, 300, 384, 6, 16, 1
    Dh = D // H
    QB = ATTN._pick_query_rows(C, L, None)
    T1 = -(-T // QB) * QB
    g = torch.Generator(device="cuda").manual_seed(21)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    lengths = torch.tensor([T, 211], dtype=torch.int32, device="cuda")
    valid = (torch.arange(T, device="cuda")[None] < lengths[:, None])[..., None]
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, T1 - T))  # noqa: E731
    static = (0, lengths, C, L, T, QB, H)

    def grads(fn, leaves, cot):
        leaves = [a.detach().clone().requires_grad_() for a in leaves]
        (fn(*leaves).float() * cot).sum().backward()
        return [a.grad for a in leaves]

    err = 0.0
    qkv = [rand(B, T, H, Dh) for _ in range(3)]
    cot = torch.where(valid[..., None], rand(B, T, H, Dh), 0.0)
    got = grads(lambda q, k, v: ATTN.banded_flash_attention(
        q, k, v, 0, lengths, chunk_size=C, left_context=L), qkv, cot)
    want = grads(lambda q, k, v: ATTN.banded_attention_fwd_reference(
        *(pad(a.reshape(B, T, D)) for a in (q, k, v)), *static
    )[0][:, :T].reshape(B, T, H, Dh), qkv, cot)
    for name, a, b in zip("qkv", got, want):
        e, _ = compare(f"BandedAttention grad d{name}", a, b, TOL[torch.float32], normwise=True)
        err = max(err, e)
    leaves = [rand(D, 3 * D) / D ** 0.5, 1.0 + 0.1 * rand(D), 0.1 * rand(D), rand(B, T, D)]
    cot = torch.where(valid, rand(B, T, D), 0.0)
    got = grads(lambda w, gg, bb, x: ATTN.fused_attention_layer(
        w, gg, bb, x, 0, lengths, chunk_size=C, left_context=L, num_heads=H), leaves, cot)
    want = grads(lambda w, gg, bb, x: ATTN.fused_attention_fwd_reference(
        pad(x), ATTN._split_rot_weights(w, H, x.dtype), gg, bb, *static, False
    )[0][:, :T], leaves, cot)
    for name, a, b in zip(("wqkv", "ln_g", "ln_b", "x"), got, want):
        check(a.dtype == torch.float32, f"FusedAttentionLayer grad d{name}: {a.dtype}")
        e, _ = compare(f"FusedAttentionLayer grad d{name}", a, b, TOL[torch.float32],
                       normwise=True)
        err = max(err, e)
    print(f"autograd Functions (BandedAttention, FusedAttentionLayer) vs autograd "
          f"through the plain forwards, f32 B=2 T'=300: max abs err {err:.3e}")
    return err


def _attention_bounds(c: dict, B: int, D: int, H: int, dtype) -> dict:
    """Least time (ms) of each kernel on ``c``: the larger of the bytes
    the function must move (each input read once, each output written
    once) at the HBM rate and its operations at the card's peak for the
    type, counting only the (query, key) pairs the band admits for this
    run's lengths."""
    T1, QB = c["T1"], c["QB"]
    offset, lengths, C, L, T = c["args"][:5]
    Dh = D // H
    es = torch.finfo(dtype).bits // 8
    pairs = float(ATTN._block_masks(B, T1, QB, L * C, C, L, T, offset, lengths, False).sum())
    seq, rows = B * T1 * D * es, B * T1 * H * 4  # one (B, T1, D) tensor; one lse
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    work = {
        # (bytes, operations): QK and PV; + G.V and dS.K; + dV and dK
        "K2f": (4 * seq + rows + 4 * B, 4 * Dh * H * pairs),
        "K2b-dq": (5 * seq + 2 * rows + 4 * B, 6 * Dh * H * pairs),
        "K2b-dkv": (6 * seq + 2 * rows + 4 * B, 8 * Dh * H * pairs),
        # x, the (D, D) weights Wq, Wk and Wv, ln g/b and frequencies in,
        # out; the q, k and v projections of every row, then the attention.
        # Wq@R and Wk@R are signed column permutations of Wq and Wk, so the
        # function needs neither their bytes nor their products.
        "K3f": (2 * seq + 3 * D * D * es + 3 * D * 4 + 4 * B,
                2.0 * B * T1 * D * 3 * D + 4 * Dh * H * pairs),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / peak
        out[name] = (1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes")
    return out


def _sdpa_ms(c: dict, B: int, D: int, H: int) -> dict:
    """One library call computing the same function, timed as a yardstick
    only: ``scaled_dot_product_attention`` with the band as a boolean
    (B, 1, T1, T1) mask; its backward as (forward + backward) - forward.
    Also its largest difference to K2f on valid rows."""
    F = torch.nn.functional
    T1 = c["T1"]
    offset, lengths, C, L, T = c["args"][:5]
    Dh = D // H
    base = torch.zeros((), dtype=torch.long, device="cuda")
    mask = ATTN._band_mask(base, base, T1, T1, C, L, T, offset, lengths.view(B, 1, 1))[:, None]
    heads = lambda a: a.view(B, T1, H, Dh).transpose(1, 2)  # noqa: E731
    q, k, v = (heads(c[n]).detach().clone().requires_grad_() for n in "qkv")
    gh = heads(c["g"])
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20)
        lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    ours, _ = ATTN.banded_attention_fwd(c["q"], c["k"], c["v"], *c["args"])
    lib_rows = lib.transpose(1, 2).reshape(B, T1, D).float()
    diff = torch.where(c["valid"], lib_rows - ours.float(), 0.0)

    def fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask).backward(gh)

    with torch.enable_grad():
        both = cuda_ms(fwd_bwd, 20)
        fwd_grad_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20)
    return {"fwd_ms": fwd_ms, "bwd_ms": both - fwd_grad_ms,
            "max_abs_diff_to_K2f": float(diff.abs().max())}


def _attention_timings(label: str, B: int, T: int) -> dict:
    """CUDA-event times (mean of 20 after warm-up; plain versions mean of
    3) of the four kernels at one conformer shape, bf16, full lengths,
    beside their bounds and the SDPA yardstick."""
    D, H, C, L = 384, 6, 16, 1
    dtype = torch.bfloat16
    c = _attention_case(B, T, D, H, C, L, 0, dtype, False, 900 + B)
    args = c["args"]
    out, lse = ATTN.banded_attention_fwd(c["q"], c["k"], c["v"], *args)
    bwd = (c["q"], c["k"], c["v"], c["g"], lse, ATTN._delta(c["g"], out, H), *args)
    fused = (c["x"], c["xw"], c["ln_g"], c["ln_b"], *args)
    calls = {
        "K2f": (lambda: ATTN.banded_attention_fwd(c["q"], c["k"], c["v"], *args),
                lambda: ATTN.banded_attention_fwd_reference(c["q"], c["k"], c["v"], *args)),
        "K2b-dq": (lambda: ATTN.banded_attention_dq(*bwd),
                   lambda: ATTN.banded_attention_dq_reference(*bwd)),
        "K2b-dkv": (lambda: ATTN.banded_attention_dkv(*bwd),
                    lambda: ATTN.banded_attention_dkv_reference(*bwd)),
        "K3f": (lambda: ATTN.fused_attention_fwd(*fused, False),
                lambda: ATTN.fused_attention_fwd_reference(*fused, False)),
    }
    bounds = _attention_bounds(c, B, D, H, dtype)
    lib = _sdpa_ms(c, B, D, H)
    # the CUDA-core bodies (the previous bf16 bodies of K2f, K2b and K3f) in
    # turns with the tensor-core bodies: old, new, new, old
    old_new = {
        "K2f": (lambda: ATTN._launch_k2f("cuda_core", c["q"], c["k"], c["v"], *args),
                calls["K2f"][0]),
        "K2b-dq": (lambda: ATTN._launch_k2b("dq", "cuda_core", *bwd), calls["K2b-dq"][0]),
        "K2b-dkv": (lambda: ATTN._launch_k2b("dkv", "cuda_core", *bwd), calls["K2b-dkv"][0]),
        "K3f": (lambda: ATTN._launch_k3f("cuda_core", *fused, False), calls["K3f"][0]),
    }
    in_turns = {}
    for name, (old, new) in old_new.items():
        t = {"cuda_core": [], "tensor_core": []}
        for which in ("cuda_core", "tensor_core", "tensor_core", "cuda_core"):
            t[which].append(cuda_ms(old if which == "cuda_core" else new, reps=20))
        in_turns[name] = {k: float(np.mean(v)) for k, v in t.items()}
    timings = {}
    for name, (kernel, plain) in calls.items():
        t = {"ms": cuda_ms(kernel, reps=20), "plain_ms": cuda_ms(plain, reps=3, warmup=1),
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
             "library_ms": None}  # K3f: no one library call computes it
        if name in in_turns:
            t["ms_cuda_core_body"] = in_turns[name]["cuda_core"]
            t["ms_tensor_core_in_turns"] = in_turns[name]["tensor_core"]
        if name == "K2f":
            t["library_ms"] = lib["fwd_ms"]
        elif name.startswith("K2b"):
            t["library_ms"] = lib["bwd_ms"]  # one backward computes dq, dk and dv
        timings[name] = t
    timings["K3f"]["ms_with_residuals"] = cuda_ms(
        lambda: ATTN.fused_attention_fwd(*fused, True), 20)
    for name, t in timings.items():
        print(f"timing {name} {label} B={B} T'={T} (T1={c['T1']}) D={D} H={H} bf16: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              + (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None else "none")
              + f", bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
              + (f", with residuals {t['ms_with_residuals']:.4f} ms" if name == "K3f" else "")
              + (f"; tensor-core body (in turns) {t['ms_tensor_core_in_turns']:.4f} ms, "
                 f"CUDA-core body {t['ms_cuda_core_body']:.4f} ms" if name in in_turns else ""))
    dq_dkv = timings["K2b-dq"]["ms"] + timings["K2b-dkv"]["ms"]
    timings["K2b_sum"] = {"ms": dq_dkv, "library_ms": lib["bwd_ms"],
                          "ms_cuda_core_bodies": in_turns["K2b-dq"]["cuda_core"]
                          + in_turns["K2b-dkv"]["cuda_core"]}
    print(f"timing K2b-dq + K2b-dkv {label}: {dq_dkv:.4f} ms (CUDA-core bodies "
          f"{timings['K2b_sum']['ms_cuda_core_bodies']:.4f} ms) against SDPA's one backward "
          f"{lib['bwd_ms']:.4f} ms")
    print(f"library yardstick (SDPA, boolean band mask) at {label}: forward "
          f"{lib['fwd_ms']:.4f} ms, backward {lib['bwd_ms']:.4f} ms, max abs diff to "
          f"K2f on valid rows {lib['max_abs_diff_to_K2f']:.3e}")
    return timings


def _k3f_bit_checks(seed: int) -> float:
    """K3f's tensor-core body at the headline head dim, B=17, ragged
    lengths, at the query block the layer plans for B=17: it matches its
    plain version at that block, two launches agree bit for bit, out
    without residuals equals out with them, and batch row 0 run alone (B=1)
    equals row 0 of B=17 bit for bit.  Returns the largest error."""
    D, H, C, L, T = 384, 6, 16, 1, 104
    QB, body = ATTN.plan_fused_layer(torch.bfloat16, 17, T, H, 128, C, L, D // H,
                                     ATTN._smem_limit("cuda"), ATTN._sm_count("cuda"))
    check(body == "tensor_core", f"K3f B=17: planned the {body} body")
    c = _attention_case(17, T, D, H, C, L, 0, torch.bfloat16, True, seed)
    check(c["T1"] % QB == 0, f"K3f B=17: T1={c['T1']} is not a multiple of {QB}")
    offset, lengths = c["args"][:2]
    args = (offset, lengths, C, L, T, QB, H)
    w = (c["xw"], c["ln_g"], c["ln_b"])
    before = read_bodies()["K3f"]["tensor_core"]
    first = ATTN.fused_attention_fwd(c["x"], *w, *args, True)
    again = ATTN.fused_attention_fwd(c["x"], *w, *args, True)
    (unsaved,) = ATTN.fused_attention_fwd(c["x"], *w, *args, False)
    alone = ATTN.fused_attention_fwd(c["x"][:1].contiguous(), *w, offset,
                                     lengths[:1].contiguous(), *args[2:], True)
    torch.cuda.synchronize()
    check(read_bodies()["K3f"]["tensor_core"] == before + 4,
          f"K3f B=17: launches by body {read_bodies()['K3f']}")
    for name, a, b, r in zip(("out", "q", "k", "v", "lse"), first, again, alone):
        check(torch.equal(a, b), f"K3f B=17 {name}: two launches differ")
        check(torch.equal(a[:1], r), f"K3f {name}: row 0 alone differs from row 0 of B=17")
    check(torch.equal(unsaved, first[0]), "K3f B=17: out without residuals differs")
    want = ATTN.fused_attention_fwd_reference(c["x"], *w, *args, True)
    err = 0.0
    for name, a, b in zip(("out", "q", "k", "v", "lse"), first, want):
        if name in ("out", "lse"):
            a, b = torch.where(c["valid"], a.float(), 0.0), torch.where(c["valid"], b.float(), 0.0)
        err = max(err, compare(f"K3f B=17 (query block {QB}) {name}", a, b,
                               TOL[torch.bfloat16])[0])
    print(f"K3f tensor-core body B=17 T'={T} ragged, query block {QB}: max abs err {err:.3e}; "
          "bit-identical on repeat; out with and without residuals equal; row 0 alone equals "
          "row 0 of B=17 bit for bit")
    return err


def _k3f_batch_1_timings() -> dict:
    """K3f at a B=1 request (T'=104, bf16, full length), in turns: the
    tensor-core body at the default 128-row query block (6 blocks) and at
    the block the layer plans for B=1 (32 rows: 24 blocks), and the
    CUDA-core body at 128 rows; with the bound."""
    D, H, C, L, T = 384, 6, 16, 1, 104
    c = _attention_case(1, T, D, H, C, L, 0, torch.bfloat16, False, 950)
    planned, _ = ATTN.plan_fused_layer(torch.bfloat16, 1, T, H, 128, C, L, D // H,
                                       ATTN._smem_limit("cuda"), ATTN._sm_count("cuda"))
    offset, lengths = c["args"][:2]
    w = (c["x"], c["xw"], c["ln_g"], c["ln_b"], offset, lengths, C, L, T)
    fns = {"tensor_core_128": lambda: ATTN._launch_k3f("tensor_core", *w, 128, H, False),
           f"tensor_core_{planned}": lambda: ATTN._launch_k3f("tensor_core", *w, planned, H,
                                                               False),
           "cuda_core_128": lambda: ATTN._launch_k3f("cuda_core", *w, 128, H, False)}
    names = list(fns)
    # device time (both of the tensor-core body's launches): CUDA events
    # around a B=1 launch time the host's launch overhead too
    ms = _device_in_turns(fns, 20, names + names[::-1], "K3f")
    bound, by = _attention_bounds(c, 1, D, H, torch.bfloat16)["K3f"]
    print(f"timing K3f B=1 T'={T} bf16 (device time, in turns): tensor-core body "
          + ", ".join(f"{k[12:]} rows {v:.4f} ms" for k, v in ms.items() if k[:12] == "tensor_core_")
          + f"; CUDA-core body 128 rows {ms['cuda_core_128']:.4f} ms; planned block {planned}; "
          f"bound {bound:.4f} ms ({by})")
    return {"ms_by_query_block": ms, "planned_query_block": planned, "bound_ms": bound,
            "bound_by": by}


def attention_kernel_phase(demo_shape) -> dict:
    """K2f, K2b-dq, K2b-dkv and K3f against their plain versions in f32
    and bf16, full and ragged lengths, at the headline training and
    batch-serving shape, the B=1 request shape, the ConformerStream window (negative and positive
    offsets), the long recording and the conformer demo trainer's own
    shape; the Functions' gradients; the timings."""
    D, H, C, L = 384, 6, 16, 1
    shapes = [
        ("headline", 256, 104, D, H, C, L, 0),
        ("serving request", 1, 104, D, H, C, L, 0),
        ("batch 17", 17, 104, D, H, C, L, 0),
        ("stream window", 1, 144, D, H, C, L, -64),
        ("stream window", 1, 144, D, H, C, L, 256),
        ("long", LONG_B, LONG_T, D, H, C, L, 0),
        # the first window of the sequence-parallel long recording (2 seq
        # ranks): its own half plus the halo, from -halo
        ("sp window", LONG_B, LONG_T // 2 + 128, D, H, C, L, -128),
        ("demo trainer", *demo_shape, 0),
        # head dims that do not divide K3f's 256 threads (8 and 4 heads)
        ("head dim 48", 16, 104, D, 8, C, L, 0),
        ("head dim 96", 16, 104, D, 4, C, L, 0),
    ]
    errs = {k: {torch.float32: 0.0, torch.bfloat16: 0.0}
            for k in ("K2f", "K2b-dq", "K2b-dkv", "K3f")}
    seed = 300
    for label, B, T, d, h, cs, lc, offset in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for ragged in (False, True):
                seed += 1
                case = (f"{label} B={B} T'={T} D={d} H={h} C={cs} L={lc} offset={offset} "
                        f"{str(dtype)[6:]} {'ragged' if ragged else 'full'}")
                c = _attention_case(B, T, d, h, cs, lc, offset, dtype, ragged, seed)
                _check_attention_case(case, c, dtype, errs)
                print(f"attention kernels {case}: max abs err "
                      + ", ".join(f"{k} {v[dtype]:.3e}" for k, v in errs.items()))
                del c
    # K3f above head dim 256, next to 48, 96 and 64 above
    wide = {}
    # 454 runs 32-column streamed tiles, 512 16-column ones (16-row blocks)
    for Dh in (288, 384, 454, 512):
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            e = _check_fused_wide_head(Dh, dtype, seed)
            errs["K3f"][dtype] = max(errs["K3f"][dtype], e)
            wide[f"{Dh} {str(dtype)[6:]}"] = e
    flash_wide = {}
    for dtype in (torch.float32, torch.bfloat16):
        seed += 1
        e = _check_flash_wide_head(dtype, seed)
        flash_wide[str(dtype)[6:]] = e
    seed += 1
    e = _k3f_bit_checks(seed)
    errs["K3f"][torch.bfloat16] = max(errs["K3f"][torch.bfloat16], e)
    grad_err = _function_grads()
    timings = {"headline": _attention_timings("headline", 256, 104),
               "long": _attention_timings("long", LONG_B, LONG_T),
               "k3f_batch_1": _k3f_batch_1_timings()}
    return {"errs": errs, "grad_err": grad_err, "timings": timings, "k3f_wide_head": wide,
            "flash_head_dim_256": flash_wide}


# --------------------------------------------------------------------------
# 7. conformer serving and streaming: main paths
# --------------------------------------------------------------------------


def conformer_config(dtype=torch.bfloat16, impl: str = "flash") -> Seq2SeqConfig:
    """The serving model with its encoder swapped for the JAX package's
    headline conformer (bench.py:149-157)."""
    return dataclasses.replace(
        serving_config(dtype, use_pallas_lstm=False), encoder_type="conformer",
        conformer=ConformerConfig(**HEADLINE_CONFORMER, attention_impl=impl),
    )


def conformer_serving_phase(params) -> dict:
    targets = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 1809)]
    rng = np.random.default_rng(0)
    singles = [rng.standard_normal((n, 469), dtype=np.float32) for n in (1248, 1000, 600)]
    batch = rng.standard_normal((256, 1248, 469), dtype=np.float32)
    nb = HEADLINE_CONFORMER["num_blocks"]
    results = {}
    for impl, kernel in (("flash", "K2f"), ("fused", "K3f")):
        config = conformer_config(impl=impl)
        predictor = OnlinePredictor(params, config, targets, max_samples=1248, device="cuda")
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        predictor(singles[0])  # warm-up
        calls = 1
        latencies = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = predictor(singles[0])
            latencies.append(time.perf_counter() - t0)
            calls += 1
        b1 = predictor(batch)
        t0 = time.perf_counter()
        b2 = predictor(batch)
        batch_s = time.perf_counter() - t0
        calls += 2
        counts = read_counts()
        bodies = read_bodies()
        # --------------------------------------------------------------
        encodes = calls * ENCODES_PER_CALL
        for k in ("K2f", "K3f"):
            check_bodies(f"conformer serving ({impl}, bf16)", bodies, k, "tensor_core",
                         counts[k])
        check_counts(f"conformer serving ({impl})", counts,
                     {kernel: encodes * nb, "K5f": encodes * nb * LN_PER_BLOCK[impl]})
        _check_response(out, 1, f"conformer {impl} single")
        _check_response(b2, 256, f"conformer {impl} batch")
        check(np.array_equal(b1["tokens"], b2["tokens"]), f"conformer {impl}: batch tokens differ")
        latency = float(np.median(latencies))
        print(f"conformer serving ({impl}): {calls} predictor calls, {counts[kernel]} {kernel} "
              f"launches ({ENCODES_PER_CALL * nb} per request), {counts['K5f']} K5f "
              f"({ENCODES_PER_CALL * nb * LN_PER_BLOCK[impl]} per request), 0 of every other "
              "kernel; "
              f"B=1 1248 samples "
              + ", ".join(f"{1e3 * x:.2f}" for x in latencies)
              + f" ms (median {1e3 * latency:.2f}); B=256 {1e3 * batch_s:.2f} ms = "
              f"{256 / batch_s:.2f} sentences/s")
        # ---- against the plain path (the banded attention, no kernel) ----
        plain = conformer_config(impl="banded")
        enc_err = 0.0
        for x in singles:
            (ok, _, _), (op, _, _) = (_encode_padded(params, config, x),
                                      _encode_padded(params, plain, x))
            check(bool(torch.isfinite(ok.float()).all()), f"conformer {impl}: non-finite encode")
            enc_err = max(enc_err, float((ok.float() - op.float()).abs().max()))
        print(f"conformer ({impl}) bf16 encoder, kernel vs plain path: max abs err {enc_err:.3e}")
        f32 = conformer_config(torch.float32, impl)
        f32_plain = conformer_config(torch.float32, "banded")
        pk = OnlinePredictor(params, f32, targets, max_samples=1248, device="cuda")
        pp = OnlinePredictor(params, f32_plain, targets, max_samples=1248, device="cuda")
        f32_err = 0.0
        for x in singles:
            (ok, fk, _), (op, fp, _) = (_encode_padded(params, f32, x),
                                        _encode_padded(params, f32_plain, x))
            for name, g, w in (("outputs", ok, op), ("pooled", fk[0], fp[0])):
                a, _ = compare(f"conformer {impl} f32 encode {len(x)} {name}", g, w,
                               TOL[torch.float32], normwise=True)
                f32_err = max(f32_err, a)
            check(np.array_equal(pk(x)["tokens"], pp(x)["tokens"]),
                  f"conformer {impl} f32 tokens of {len(x)} samples: kernel path != plain path")
        print(f"conformer ({impl}) f32 encoder, kernel vs plain path: max abs err "
              f"{f32_err:.3e}; greedy tokens identical")
        prof1 = profile_call(f"conformer {impl} B=1", lambda: predictor(singles[0]),
                             need=(kernel, "K5f"))
        prof256 = profile_call(f"conformer {impl} B=256", lambda: predictor(batch),
                               need=(kernel, "K5f"))
        results[impl] = {"counts": counts, "bodies": bodies, "calls": calls, "latency_s": latency,
                         "latencies_s": latencies, "batch_s": batch_s,
                         "enc_err_bf16": enc_err, "enc_err_f32": f32_err,
                         "profile_b1": prof1, "profile_b256": prof256}
    return results


def conformer_stream_phase(params) -> dict:
    """``ConformerStream`` (flash, f32, B=1) over 6 chunks, the last with
    11 valid steps: each emitted chunk equals the offline encode's rows."""
    ccfg = ConformerConfig(**HEADLINE_CONFORMER, attention_impl="flash")
    enc = params["encoder"]["conformer"]
    C, n_chunks = ccfg.chunk_size, 6
    n_valid = n_chunks * C - 5
    x = torch.randn((1, n_chunks * C, 100), generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    stream = ConformerStream(enc, ccfg, compute_dtype=torch.float32)
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    outs = [stream.push(x[:, i * C:(i + 1) * C], n_valid - i * C if i == n_chunks - 1 else None)
            for i in range(n_chunks)]
    counts = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    check_bodies("conformer stream (f32)", bodies, "K2f", "cuda_core", counts["K2f"])
    check_counts("conformer stream", counts,
                 {"K2f": n_chunks * ccfg.num_blocks,
                  "K5f": n_chunks * ccfg.num_blocks * LN_PER_BLOCK["flash"]})
    with torch.inference_mode():
        offline, _ = conformer_encode(enc, ccfg, x, torch.tensor([n_valid], device="cuda",
                                                                  dtype=torch.int32))
    err = 0.0
    for i, got in enumerate(outs):
        rows = min(C, n_valid - i * C)
        a, _ = compare(f"stream chunk {i}", got[:, :rows], offline[:, i * C:i * C + rows],
                       TOL[torch.float32])
        err = max(err, a)
    print(f"conformer stream (flash, f32, window {stream.window_steps} steps): {n_chunks} chunks "
          f"(last {n_valid - (n_chunks - 1) * C} valid) == offline encode, max abs err {err:.3e}; "
          f"{counts['K2f']} K2f and {counts['K5f']} K5f launches")
    return {"counts": counts, "bodies": bodies, "err": err}


# --------------------------------------------------------------------------
# 8. conformer training and the long recording: main paths
# --------------------------------------------------------------------------


def _conformer_f32_kernel_vs_plain(params, data, idx) -> float:
    """Loss and every gradient leaf of one f32 batch, the flash and fused
    paths against the plain (banded) path; no dropout draws differ (same
    generator seed)."""
    batch = {k: v[0][torch.as_tensor(idx, device="cuda")] for k, v in data.items()}
    batch["subject_idx"] = 0
    out = {}
    before = read_bodies()
    for impl in ("flash", "fused", "banded"):
        cfg = conformer_config(torch.float32, impl)
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        gen = torch.Generator(device="cuda").manual_seed(7)
        loss, _ = seq2seq_loss(p, cfg, batch, gen, train=True, penalty_scales=PENALTIES)
        loss.backward()
        out[impl] = (loss.detach(), [t.grad for t in tree_leaves(p)])
    for kernel in ("K2b-dq", "K2b-dkv", "K3f"):
        f32_bodies = {b: n - before[kernel][b] for b, n in read_bodies()[kernel].items()}
        check(f32_bodies["tensor_core"] == 0 and f32_bodies["cuda_core"] > 0,
              f"conformer f32 training: {kernel} launches by body {f32_bodies}, expected the "
              "CUDA-core body")
    err = 0.0
    lp, gp = out["banded"]
    for impl in ("flash", "fused"):
        lk, gk = out[impl]
        e, _ = compare(f"conformer f32 loss, {impl} vs plain", lk, lp, TOL[torch.float32])
        err = max(err, e)
        for i, (a, b) in enumerate(zip(gk, gp)):
            e, _ = compare(f"conformer f32 gradient leaf {i}, {impl} vs plain", a, b,
                           TOL[torch.float32], normwise=True)
            err = max(err, e)
    print(f"conformer f32 training batch of {len(idx)}, flash and fused vs plain path: loss "
          f"{float(out['flash'][0]):.6f} / {float(out['fused'][0]):.6f} vs {float(lp):.6f}; "
          f"{len(gp)} gradient leaves; max abs err {err:.3e}")
    return err


def conformer_training_phase(params) -> dict:
    """The headline conformer model, bf16, dropout on, B=256 x up to 1248
    samples: TRAIN_STEPS steps of the segment runner under 'flash', then
    under 'fused'."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    results = {}
    for impl, kernel in (("flash", "K2f"), ("fused", "K3f")):
        config = conformer_config(impl=impl)
        p = tree_map(lambda t: t.detach().clone(), params)
        data = _random_corpus(config)
        state = TrainState(p, tree_map(lambda t: t.detach().clone(), p),
                           make_optimizer(p, 1e-3), 0)
        runner = make_segment_runner(config, PENALTIES, 0.99)
        rng = np.random.default_rng(0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        subject = np.zeros((1,), np.int32)

        def step() -> float:
            nonlocal state
            idx = rng.permutation(N_TRIALS)[:B_TRAIN][None]
            state, metrics = runner(state, data, subject, idx, gen, 0)
            return float(metrics["loss_total"])  # waits for the step

        t0 = time.perf_counter()
        losses = [step()]
        first_s = time.perf_counter() - t0
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            step_s.append(time.perf_counter() - t0)
        counts = read_counts()
        bodies = read_bodies()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        # ------------------------------------------------------------------
        want = TRAIN_STEPS * nb
        for k in ("K2f", "K2b-dq", "K2b-dkv", "K3f"):
            check_bodies(f"conformer training ({impl}, bf16)", bodies, k, "tensor_core",
                         counts[k])
        check_bodies(f"conformer training ({impl}, bf16)", bodies, "K5b", "registers",
                     counts["K5b"])
        ln = want * LN_PER_BLOCK[impl]
        check_counts(f"conformer training ({impl})", counts,
                     {kernel: want, "K2b-dq": want, "K2b-dkv": want, "K5f": ln, "K5b": ln})
        check(all(np.isfinite(losses)), f"conformer {impl}: non-finite training loss {losses}")
        check(losses[-1] < losses[0], f"conformer {impl}: training loss did not fall: {losses}")
        ms = 1e3 * float(np.mean(step_s))
        print(f"conformer training ({impl}) B={B_TRAIN} x {T_RAW} samples, bf16, dropout on: "
              "losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; per step {nb} {kernel} + {nb} K2b-dq + {nb} K2b-dkv + "
              f"{nb * LN_PER_BLOCK[impl]} K5f + {nb * LN_PER_BLOCK[impl]} K5b launches")
        print(f"conformer training step ({impl}): first {1e3 * first_s:.2f} ms, then "
              + ", ".join(f"{1e3 * x:.2f}" for x in step_s)
              + f" ms; mean {ms:.2f} ms = {B_TRAIN / (ms / 1e3):.2f} sentences/s; peak device "
              f"memory {peak_gib:.2f} GiB (corpus included)")
        prof = profile_call(f"conformer training step ({impl}) B={B_TRAIN}", step,
                            need=(kernel, "K2b-dq", "K2b-dkv", "K5f", "K5b"))
        results[impl] = {"counts": counts, "bodies": bodies, "ms": ms, "losses": losses,
                         "profile": prof}
        if impl == "flash":
            results["plain_layernorm"] = _steps_with_plain_layernorm(step)
        del data, state
    idx = np.random.default_rng(1).permutation(N_TRIALS)[:64]
    results["f32_err"] = _conformer_f32_kernel_vs_plain(
        params, _random_corpus(conformer_config()), idx)
    return results


def _steps_with_plain_layernorm(step, n: int = 3) -> dict:
    """A finding, not a path: the flash training step with the conformer's
    ``_layernorm`` swapped back to the plain math (as the JAX package's
    scripts/layernorm_bench.py swaps its kernel in), in turns with the
    K5 step: plain, K5, K5, plain, ``n`` steps each."""
    real = conformer_module._layernorm

    def plain(p, x, eps=1e-6):
        return layernorm_kernels.layer_norm_fwd_reference(x, p["g"], p["b"], eps)

    times = {"plain": [], "K5": []}
    for which in ("plain", "K5", "K5", "plain"):
        conformer_module._layernorm = plain if which == "plain" else real
        try:
            reset_counts()
            for _ in range(n):
                t0 = time.perf_counter()
                step()
                times[which].append(time.perf_counter() - t0)
            k5 = read_counts()["K5f"]
        finally:
            conformer_module._layernorm = real
        check((k5 == 0) == (which == "plain"), f"plain-LayerNorm timing: {which} ran {k5} K5f")
    ms = {k: 1e3 * float(np.mean(v)) for k, v in times.items()}
    print(f"conformer flash training step, LayerNorm as K5f/K5b vs the plain math (in turns, "
          f"{2 * n} steps each): {ms['K5']:.2f} vs {ms['plain']:.2f} ms")
    return {"K5_ms": ms["K5"], "plain_ms": ms["plain"]}


def long_recording_phase(params) -> dict:
    """``conformer_encode`` forward and backward at B=16, T'=8192 steps of
    100 features, bf16, attention_impl 'auto' (the JAX package's
    long-recording cell, bench.py:255-300): the kernels must run."""
    ccfg = ConformerConfig(**HEADLINE_CONFORMER)  # 'auto'
    enc = tree_map(lambda t: t.detach().clone().requires_grad_(), params["encoder"]["conformer"])
    leaves = tree_leaves(enc)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((LONG_B, LONG_T, LONG_IN), generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.full((LONG_B,), LONG_T, dtype=torch.int32, device="cuda")

    def fwd_bwd():
        out, _ = conformer_encode(enc, ccfg, x, lengths, compute_dtype=torch.bfloat16)
        grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
        return grads

    def fwd():
        with torch.inference_mode():
            return conformer_encode(enc, ccfg, x, lengths, compute_dtype=torch.bfloat16)[0]

    grads = fwd_bwd()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in grads), "long recording: non-finite gradients")
    iters = 3
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        fwd_bwd()
    torch.cuda.synchronize()
    train_s = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fwd()
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / iters
    counts = read_counts()
    bodies = read_bodies()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # ------------------------------------------------------------------
    nb = ccfg.num_blocks
    for kernel in ("K2f", "K2b-dq", "K2b-dkv"):
        check_bodies("long recording (bf16)", bodies, kernel, "tensor_core", counts[kernel])
    check_bodies("long recording (bf16)", bodies, "K5b", "registers", counts["K5b"])
    ln = nb * LN_PER_BLOCK["flash"]
    check_counts("long recording", counts,
                 {"K2f": 2 * iters * nb, "K2b-dq": iters * nb, "K2b-dkv": iters * nb,
                  "K5f": 2 * iters * ln, "K5b": iters * ln})
    check(bool(torch.isfinite(out.float()).all()), "long recording: non-finite encoder output")
    tokens = LONG_B * LONG_T
    print(f"long recording B={LONG_B} T'={LONG_T} bf16 ('auto' -> flash): forward+backward "
          f"{1e3 * train_s:.2f} ms = {tokens / train_s:.0f} tokens/s; forward {1e3 * fwd_s:.2f} ms "
          f"= {tokens / fwd_s:.0f} tokens/s; launches {counts}; peak device memory "
          f"{peak_gib:.2f} GiB")
    prof = profile_call(f"long recording forward+backward B={LONG_B} T'={LONG_T}", fwd_bwd,
                        need=("K2f", "K2b-dq", "K2b-dkv", "K5f", "K5b"))
    return {"counts": counts, "bodies": bodies, "train_s": train_s, "fwd_s": fwd_s,
            "train_tokens_per_s": tokens / train_s, "fwd_tokens_per_s": tokens / fwd_s,
            "profile": prof, "peak_gib": peak_gib}


# --------------------------------------------------------------------------
# 9. the trainer with a conformer encoder: a main path
# --------------------------------------------------------------------------


def demo_conformer_trainer(root: str) -> MultiSubjectTrainer:
    """The demo experiment's trainer with a small conformer encoder
    (flash attention), bf16, dropout on."""
    manifest = make_demo_experiment(
        f"{root}/conformer_exp", subject_ids=(1,), N_epochs=40, FF_dropout=0.1,
        RNN_dropout=0.5,
    )
    return MultiSubjectTrainer(
        manifest, [1], VERBOSE=False, device="cuda",
        SN_kwargs={"encoder_type": "conformer", "conformer": DEMO_CONFORMER,
                   "compute_dtype": "bfloat16", "batch_size": 16, "learning_rate": 3e-3,
                   "max_dec_len": 10},
    )


def conformer_trainer_shape(trainer: MultiSubjectTrainer) -> tuple:
    """(B, T', D, H, C, L) of the attention kernels in the trainer's steps."""
    cfg = trainer.net_config
    ccfg = cfg.conformer
    T_pad = trainer.packed_dataset("training").encoder_inputs.shape[2]
    return (trainer.batch_size, T_pad // cfg.decimation_factor, ccfg.model_dim,
            ccfg.num_heads, ccfg.chunk_size, ccfg.left_context)


def conformer_trainer_phase(trainer: MultiSubjectTrainer) -> dict:
    counts_n = trainer.packed_dataset("training").num_trials
    steps = trainer.N_epochs * sum(-(-int(n) // trainer.batch_size) for n in counts_n if n)
    nb = trainer.net_config.conformer.num_blocks
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.parallel_transfer_learn()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    for kernel in ("K2f", "K2b-dq", "K2b-dkv"):
        check_bodies("conformer trainer (bf16)", bodies, kernel, "tensor_core", counts[kernel])
    check_bodies("conformer trainer (bf16)", bodies, "K5b", "registers", counts["K5b"])
    check(counts["K2b-dq"] == counts["K2b-dkv"] == steps * nb,
          f"conformer trainer: K2b launched {counts} in {steps} steps; expected "
          f"{steps * nb} of each")
    ln = steps * nb * LN_PER_BLOCK["flash"]
    check(counts["K5b"] == ln and counts["K5f"] >= ln,
          f"conformer trainer: K5 launched {counts} in {steps} steps; expected {ln} K5b")
    check(counts["K2f"] >= steps * nb
          and all(counts[k] == 0 for k in ("K1f", "K1b", "K3f", "K4f", "K4b")),
          f"conformer trainer: launches {counts}")
    wers = [snap["training"]["word_error_rate"] for snap in history.values()]
    check(all(np.isfinite(wers)) and wers[-1] < wers[0],
          f"conformer trainer: training WER did not fall: {wers}")
    predictor = OnlinePredictor.from_trainer(trainer)
    val = trainer.packed_dataset("validation")
    out = predictor(val.encoder_inputs[0, 0, : int(val.encoder_lengths[0, 0])])
    check(out["tokens"].shape == (1, trainer.net_config.max_dec_len)
          and bool(np.isfinite(out["probabilities"]).all()),
          f"conformer trainer: served tokens {out['tokens']}")
    print(f"conformer trainer (demo experiment, {DEMO_CONFORMER}, bf16): {steps} steps in "
          f"{fit_s:.2f} s with 4 assessments; training WER by assessment "
          + ", ".join(f"{w:.3f}" for w in wers)
          + f"; launches {counts} ({nb} K2b-dq, {nb} K2b-dkv and "
          f"{nb * LN_PER_BLOCK['flash']} K5b per step)")
    print(f"served validation trial 0: {out['sequences'][0]!r} "
          f"(reference {' '.join(val.references[0][0])!r})")
    return {"wers": wers, "steps": steps, "counts": counts, "bodies": bodies, "fit_s": fit_s}


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# 10. beam search, the conformer session and pool, CTC training, export:
#     main paths
# --------------------------------------------------------------------------

SPC = 12 * HEADLINE_CONFORMER["chunk_size"]  # raw samples a streamed chunk
TARGETS = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 1809)]


def _demo_phonemes() -> list:
    return read_vocab_file(os.path.join(text_dir, "vocab.demo-phonemes.20"))


def ctc_config(dtype=torch.bfloat16, impl: str = "flash") -> Seq2SeqConfig:
    """The headline conformer with a CTC aux head (the bench's MLP of 225
    units, one class a phoneme of ``vocab.demo-phonemes.20`` and the blank)."""
    head = AuxHead("encoder_1_targets", "CTC", len(_demo_phonemes()) + 1)
    return dataclasses.replace(conformer_config(dtype, impl), aux_heads=(head,))


def _cuda_batch(x: np.ndarray):
    lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device="cuda")
    return torch.from_numpy(x).cuda(), lengths


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def beam_phase(conf_params) -> dict:
    """``beam_decode`` (width 4, alpha 0.6) over the full-width biLSTM at
    B=256 x 1248 samples and B=1, under True (6 K1f a call: one encode) and
    'bi_grid' (3 K4f), timed beside the greedy decode; width 1 equals the
    greedy decode in f32; then the headline conformer under 'fused' (K3f)."""
    x256, l256 = _cuda_batch(np.random.default_rng(0).standard_normal(
        (256, T_RAW, 469), dtype=np.float32))
    x1, l1 = x256[:1], l256[:1]
    results = {}
    for mode, kernel, per_call in ((True, "K1f", LAUNCHES_PER_ENCODE), ("bi_grid", "K4f", 3)):
        config = serving_config(use_pallas_lstm=mode)
        params = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")

        def beam(x, lens):
            with torch.inference_mode():
                return beam_decode(params, config, x, lens, 0, beam_width=4, alpha=0.6)

        def greedy(x, lens):
            with torch.inference_mode():
                return greedy_decode(params, config, x, lens, 0, temperature=0.0)

        beam(x256, l256), greedy(x256, l256)  # warm-up
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        b1, b1_s = _timed(lambda: beam(x1, l1))
        b256, b256_s = _timed(lambda: beam(x256, l256))
        counts = read_counts()
        bodies = read_bodies()
        # --------------------------------------------------------------
        check_counts(f"beam ({mode})", counts, {kernel: 2 * per_call})
        check_bodies(f"beam ({mode}, bf16)", bodies, kernel, "cluster", 2 * per_call)
        g256, g256_s = _timed(lambda: greedy(x256, l256))
        for name, out, B in (("B=1", b1, 1), ("B=256", b256, 256)):
            check(tuple(out.shape) == (B, 20), f"beam {mode} {name}: shape {tuple(out.shape)}")
            check(bool(((out >= 0) & (out < 1809)).all()), f"beam {mode} {name}: ids")
        agree = float((b256 == g256).float().mean())
        print(f"beam ({mode}, bf16, width 4, alpha 0.6): {counts[kernel]} {kernel} launches "
              f"in 2 calls ({per_call} a call), 0 of every other kernel; B=1 "
              f"{1e3 * b1_s:.2f} ms; B=256 {1e3 * b256_s:.2f} ms = {256 / b256_s:.2f} "
              f"sentences/s beside greedy's {1e3 * g256_s:.2f} ms = {256 / g256_s:.2f}; "
              f"tokens equal to greedy's {100 * agree:.1f} %  [{gpu_line()}]")
        results[str(mode)] = {"counts": counts, "bodies": bodies, "b1_ms": 1e3 * b1_s,
                              "sentences_per_s_b256": 256 / b256_s,
                              "greedy_sentences_per_s_b256": 256 / g256_s}
    f32 = serving_config(torch.float32)
    p32 = init_seq2seq(f32, torch.Generator().manual_seed(0), device="cuda")
    with torch.inference_mode():
        beam1 = beam_decode(p32, f32, x256[:16], l256[:16], 0, beam_width=1, alpha=0.0)
        greedy = greedy_decode(p32, f32, x256[:16], l256[:16], 0, temperature=0.0)
    check(torch.equal(beam1, greedy), "beam width 1 (f32) != greedy decode")
    nb = HEADLINE_CONFORMER["num_blocks"]
    fused = conformer_config(impl="fused")

    def conformer_beam():
        with torch.inference_mode():
            return beam_decode(conf_params, fused, x256, l256, 0, beam_width=4, alpha=0.6)

    conformer_beam()  # warm-up
    reset_counts()
    cb, cb_s = _timed(conformer_beam)
    counts = read_counts()
    check_counts("beam (conformer, fused)", counts, {"K3f": nb, "K5f": nb * LN_PER_BLOCK["fused"]})
    check(tuple(cb.shape) == (256, 20), "beam (conformer): shape")
    print(f"beam over the headline conformer ('fused', bf16) B=256: {counts['K3f']} K3f + "
          f"{counts['K5f']} K5f launches, {1e3 * cb_s:.2f} ms = {256 / cb_s:.2f} sentences/s; "
          "width 1 (f32, True) == greedy")
    results["conformer_fused"] = {"counts": counts, "sentences_per_s_b256": 256 / cb_s}
    return results


def _ragged(x: np.ndarray, rng) -> list:
    cuts = np.cumsum(rng.integers(40, 400, size=len(x) // 40))
    return np.split(x, cuts[cuts < len(x)])


def _stream_offline(params, config, raw: np.ndarray):
    """The offline greedy decode of one utterance, padded to a multiple of
    the decimation factor (as the pipeline pads it)."""
    L = len(raw)
    padded = np.zeros((1, -(-L // 12) * 12, raw.shape[1]), np.float32)
    padded[0, :L] = raw
    x = torch.from_numpy(padded).cuda()
    lens = torch.tensor([L], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        return greedy_decode(params, config, x, lens, 0, temperature=0.0).cpu().numpy()


def session_phase(params) -> dict:
    """``StreamingConformerSession`` over the headline conformer with a CTC
    head, bf16, B=1, under 'flash' (K2f) and 'fused' (K3f): ragged packets
    of a 1248-sample utterance with two mid-stream ``decode()``s, then a
    recording 8x as long a chunk at a time with ``partial()`` greedy and
    with the demo lexicon after each chunk; then in f32 the endpoints
    against the offline decode, exactly."""
    phonemes = _demo_phonemes()
    words = read_vocab_file(os.path.join(text_dir, "vocab.demo.36"))
    lexicon = LexiconTrie(build_lexicon(words, word_to_phonemes, phonemes))
    rng = np.random.default_rng(3)
    utt = rng.standard_normal((T_RAW, 469), dtype=np.float32)
    rec = rng.standard_normal((8 * T_RAW, 469), dtype=np.float32)  # 52 chunks
    nb = HEADLINE_CONFORMER["num_blocks"]
    results = {"native_beam": _load_native() is not None}
    for impl, kernel in (("flash", "K2f"), ("fused", "K3f")):
        session = StreamingConformerSession(params, ctc_config(impl=impl), TARGETS,
                                            phoneme_list=phonemes, device="cuda")
        session.push(utt[:SPC])  # warm-up
        session.partial(lexicon=lexicon)
        session.reset()
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        encodes = 0
        for i, pkt in enumerate(_ragged(utt, rng)):
            before = len(session._enc_outs)
            session.push(pkt)
            encodes += len(session._enc_outs) - before
            if i == 3:
                encodes += 2 * bool(session._raw_samples)
                a, b = session.decode(), session.decode()
                check(np.array_equal(a["tokens"], b["tokens"]), f"session {impl}: decode repeats")
        encodes += bool(session._raw_samples)
        utt_out = session.endpoint()
        chunk_s, greedy_s, lex_s = [], [], []
        for lo in range(0, len(rec), SPC):
            _, dt = _timed(lambda: session.push(rec[lo: lo + SPC]))
            chunk_s.append(dt)
            encodes += 1
            _, dt = _timed(session.partial)
            greedy_s.append(dt)
            live, dt = _timed(lambda: session.partial(lexicon=lexicon))
            lex_s.append(dt)
        logp = np.concatenate(session._ctc_logps, axis=0)[: session._enc_steps]
        scratch = ctc_word_beam_search(logp[:, 0], lexicon, beam_width=8)
        rec_out = session.endpoint()
        counts = read_counts()
        bodies = read_bodies()
        # --------------------------------------------------------------
        check_counts(f"session ({impl})", counts,
                     {kernel: encodes * nb, "K5f": encodes * nb * LN_PER_BLOCK[impl]})
        check_bodies(f"session ({impl}, bf16)", bodies, kernel, "tensor_core", counts[kernel])
        check(live["words"][0] == scratch, f"session {impl}: carried lexicon beam != from scratch")
        check(live["num_steps"] == 8 * T_RAW // 12, f"session {impl}: {live['num_steps']} steps")
        for name, out in (("utterance", utt_out), ("recording", rec_out)):
            check(out["tokens"].shape == (1, 20), f"session {impl} {name}: tokens shape")
            check(bool(np.isfinite(out["encoder_outputs"]).all()), f"session {impl} {name}")
        med = {k: 1e3 * float(np.median(v)) for k, v in
               (("chunk", chunk_s), ("greedy", greedy_s), ("lexicon", lex_s))}
        print(f"session ({impl}, bf16, B=1, CTC head of {len(phonemes) + 1} classes): "
              f"{encodes} window encodes, {counts[kernel]} {kernel} + {counts['K5f']} K5f "
              f"launches; per chunk of {SPC} samples median {med['chunk']:.3f} ms; partial() "
              f"median greedy {med['greedy']:.3f} ms, lexicon ({len(lexicon.root) - 1} first "
              f"phonemes, beam 8, {'C++' if results['native_beam'] else 'Python'} search) "
              f"{med['lexicon']:.3f} ms; carried lexicon beam == from scratch  [{gpu_line()}]")
        # ---- f32: the endpoints against the offline decode, exactly ----
        f32 = ctc_config(torch.float32, impl)
        s32 = StreamingConformerSession(params, f32, TARGETS, phoneme_list=phonemes,
                                        device="cuda")
        for raw in (utt, rec):
            for pkt in _ragged(raw, rng):
                s32.push(pkt)
            got = s32.endpoint()["tokens"]
            check(np.array_equal(got, _stream_offline(params, f32, raw)),
                  f"session {impl} f32 ({len(raw)} samples): endpoint != offline decode")
        print(f"session ({impl}, f32): endpoint tokens == offline greedy_decode for "
              f"{T_RAW} and {8 * T_RAW} samples")
        results[impl] = {"counts": counts, "bodies": bodies, "encodes": encodes,
                         "chunk_ms": med["chunk"], "partial_greedy_ms": med["greedy"],
                         "partial_lexicon_ms": med["lexicon"]}
    return results


def _pool_schedule(pool, rng, events: int = 40) -> tuple:
    """A seeded schedule of joins, ragged pushes and endpoints: each
    finished stream's samples and pooled endpoint."""
    live, done = {}, []
    for _ in range(events):
        roll = rng.random()
        if (roll < 0.3 and len(live) < pool.capacity) or not live:
            live[pool.add()] = []
        elif roll < 0.85:
            slot = int(rng.choice(list(live)))
            pkt = rng.standard_normal((int(rng.integers(20, 500)), 469), dtype=np.float32)
            live[slot].append(pkt)
            pool.push(slot, pkt)
        else:
            slot = int(rng.choice(list(live)))
            done.append((np.concatenate(live.pop(slot) or [np.zeros((0, 469), np.float32)]),
                         pool.endpoint(slot)))
    for slot in list(live):
        done.append((np.concatenate(live.pop(slot) or [np.zeros((0, 469), np.float32)]),
                     pool.endpoint(slot)))
    return done


def _dedicated(params, config, samples, **kw) -> dict:
    session = StreamingConformerSession(params, config, TARGETS, device="cuda", **kw)
    if len(samples):
        session.push(samples)
    return session.endpoint()


def pool_phase(params) -> dict:
    """``StreamingSessionPool`` at capacity 8 over the headline conformer
    (the window's attention pinned to 'dense', its LayerNorms on K5f): a
    random schedule of joins, ragged pushes and leaves; each stream's
    endpoint against a dedicated session under the same pinned impl
    (bf16: encoder outputs within the bf16 tolerance; f32: tokens exact);
    the int8 upload against its session and the offline decode of the
    dequantized input; the tick time at capacity 8."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    dense16, dense32 = ctc_config(impl="dense"), ctc_config(torch.float32, "dense")
    pool = StreamingSessionPool(params, ctc_config(), TARGETS, capacity=8, device="cuda")
    ticks = 0
    tick = pool._tick

    def counted_tick(*args, **kwargs):
        nonlocal ticks
        ticks += 1
        return tick(*args, **kwargs)

    pool._tick = counted_tick
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    done = _pool_schedule(pool, np.random.default_rng(5))
    counts = read_counts()
    # ------------------------------------------------------------------
    check_counts(f"pool ({ticks} ticks)", counts, {"K5f": ticks * nb * LN_PER_BLOCK["flash"]})
    enc_err = 0.0
    for samples, got in done:
        want = _dedicated(params, dense16, samples)
        if got["tokens"] is None:
            check(want["tokens"] is None, "pool bf16: an empty stream decoded")
            continue
        # normwise: the batched window's products round in another order
        # than a B=1 window's, and four bf16 blocks carry each rounding on
        # at the scale of the row, not of the element
        a, _ = compare("pool bf16 endpoint vs session", torch.from_numpy(got["encoder_outputs"]),
                       torch.from_numpy(want["encoder_outputs"]), TOL[torch.bfloat16],
                       normwise=True)
        enc_err = max(enc_err, a)
    pool32 = StreamingSessionPool(params, ctc_config(torch.float32), TARGETS, capacity=8,
                                  device="cuda")
    done32 = _pool_schedule(pool32, np.random.default_rng(6))
    for samples, got in done32:
        want = _dedicated(params, dense32, samples)
        check(np.array_equal(got["tokens"], want["tokens"]) if got["tokens"] is not None
              else want["tokens"] is None, "pool f32: tokens != dedicated session's")
    # int8 upload: pool == session == offline on the dequantized input (f32)
    raw = np.random.default_rng(7).standard_normal((1000, 469), dtype=np.float32)
    pool8 = StreamingSessionPool(params, dense32, TARGETS, capacity=2, device="cuda",
                                 host_upload="int8")
    slot = pool8.add()
    for pkt in np.split(raw, [333, 500, 777]):
        pool8.push(slot, pkt)
    got = pool8.endpoint(slot)["tokens"]
    dq = np.zeros_like(raw)
    for lo in range(0, len(raw), SPC):
        block = np.zeros((1, SPC, 469), np.float32)
        n = min(SPC, len(raw) - lo)
        block[0, :n] = raw[lo: lo + n]
        q, scales = _quantize_host_block(block)
        dq[lo: lo + n] = (q.astype(np.float32) * scales[:, None, :])[0, :n]
    check(np.array_equal(got, _dedicated(params, dense32, raw, host_upload="int8")["tokens"]),
          "pool int8: tokens != dedicated int8 session's")
    check(np.array_equal(got, _stream_offline(params, dense32, dq)),
          "pool int8: tokens != offline decode of the dequantized input")
    # the tick at capacity 8 (bf16): seven slots hold a chunk, the eighth's
    # push runs the batched tick
    timing = StreamingSessionPool(params, ctc_config(), TARGETS, capacity=8, device="cuda")
    slots = [timing.add() for _ in range(8)]
    chunk = np.random.default_rng(8).standard_normal((SPC, 469), dtype=np.float32)
    tick_s = []
    for _ in range(12):
        for s in slots[:-1]:
            timing.push(s, chunk)
        _, dt = _timed(lambda: timing.push(slots[-1], chunk))
        tick_s.append(dt)
    tick_ms = 1e3 * float(np.median(tick_s[2:]))
    print(f"pool (capacity 8, bf16, window attention pinned 'dense'): {len(done)} streams, "
          f"{ticks} ticks, {counts['K5f']} K5f launches ({nb * LN_PER_BLOCK['flash']} a tick), "
          f"0 of every other kernel; endpoints vs dedicated sessions: bf16 encoder max abs err "
          f"{enc_err:.3e}, f32 tokens identical over {len(done32)} streams; int8 upload == "
          f"session == offline on the dequantized input; tick at capacity 8 median "
          f"{tick_ms:.3f} ms  [{gpu_line()}]")
    return {"counts": counts, "ticks": ticks, "tick_ms": tick_ms, "enc_err_bf16": enc_err}


def ctc_training_phase(params) -> dict:
    """The headline conformer with the CTC head, B=256, bf16, dropout on,
    TRAIN_STEPS steps under 'flash': a falling loss; then ``ctc_loss`` on
    the card (the plain recursion in torch) against the same on the CPU,
    value and gradient, f32."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    config = ctc_config()
    p = tree_map(lambda t: t.detach().clone(), params)
    data = _random_corpus(config)
    g = torch.Generator(device="cuda").manual_seed(1)
    n_classes = len(_demo_phonemes())
    data["encoder_1_targets"] = torch.randint(0, n_classes, (1, N_TRIALS, 24), generator=g,
                                              device="cuda", dtype=torch.int32)
    # at most 24 labels in at least 52 encoder steps: every row can be aligned
    data["encoder_1_targets_lengths"] = torch.randint(4, 25, (1, N_TRIALS), generator=g,
                                                      device="cuda", dtype=torch.int32)
    state = TrainState(p, tree_map(lambda t: t.detach().clone(), p), make_optimizer(p, 1e-3), 0)
    runner = make_segment_runner(config, PENALTIES, 0.99)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    subject = np.zeros((1,), np.int32)

    def step() -> tuple:
        nonlocal state
        idx = rng.permutation(N_TRIALS)[:B_TRAIN][None]
        state, metrics = runner(state, data, subject, idx, gen, 0)
        return float(metrics["loss_total"]), float(metrics["loss_encoder_1_targets"])

    losses = [step()]
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    want = TRAIN_STEPS * nb
    ln = want * LN_PER_BLOCK["flash"]
    check_counts("CTC training (flash)", counts,
                 {"K2f": want, "K2b-dq": want, "K2b-dkv": want, "K5f": ln, "K5b": ln})
    for k in ("K2f", "K2b-dq", "K2b-dkv"):
        check_bodies("CTC training (bf16)", bodies, k, "tensor_core", counts[k])
    total = [t for t, _ in losses]
    check(all(np.isfinite(total)), f"CTC training: non-finite loss {losses}")
    check(total[-1] < total[0], f"CTC training: loss did not fall: {losses}")
    ms = 1e3 * float(np.mean(step_s))
    # ctc_loss on the card against the same recursion on the CPU
    logits = torch.randn((T_STEPS, B_TRAIN, n_classes + 1), generator=g, device="cuda")
    lens = torch.randint(T_STEPS // 2, T_STEPS + 1, (B_TRAIN,), generator=g, device="cuda")
    labels, lab_l = data["encoder_1_targets"][0, :B_TRAIN], data["encoder_1_targets_lengths"][0, :B_TRAIN]
    errs = []
    for dev in ("cuda", "cpu"):
        x = logits.detach().to(dev, copy=True).requires_grad_(True)
        loss = ctc_loss(x, lens.to(dev), labels.to(dev), lab_l.to(dev))
        loss.backward()
        errs.append((loss.detach().cpu(), x.grad.cpu()))
    compare("ctc_loss card vs CPU", errs[0][0], errs[1][0], TOL[torch.float32])
    grad_err, _ = compare("ctc_loss gradient card vs CPU", errs[0][1], errs[1][1],
                          TOL[torch.float32])
    loss_ms = cuda_ms(lambda: ctc_loss(logits, lens, labels, lab_l), 5)
    print(f"CTC training ('flash', B={B_TRAIN}, bf16, dropout on): (total, CTC) losses "
          + ", ".join(f"({t:.4f}, {c:.4f})" for t, c in losses)
          + f"; per step {nb} K2f + {nb} K2b-dq + {nb} K2b-dkv + {nb * 5} K5f + {nb * 5} K5b; "
          f"mean step {ms:.2f} ms = {B_TRAIN / (ms / 1e3):.2f} sentences/s; ctc_loss on the card "
          f"== the CPU recursion (gradient max abs err {grad_err:.3e}), forward {loss_ms:.3f} ms "
          f"at T'={T_STEPS} B={B_TRAIN}  [{gpu_line()}]")
    return {"counts": counts, "bodies": bodies, "ms": ms, "losses": losses,
            "ctc_loss_fwd_ms": loss_ms, "grad_err": grad_err}


def export_phase() -> dict:
    """``export_predictor`` of the full-width biLSTM predictor under True and
    'bi_grid', loaded back in the same process: its tokens equal the live
    predictor's, and its calls launch K1f / K4f through the program."""
    rng = np.random.default_rng(9)
    requests = [rng.standard_normal((T_RAW, 469), dtype=np.float32),
                rng.standard_normal((4, 1000, 469), dtype=np.float32),
                rng.standard_normal((600, 469), dtype=np.float32)]
    results = {}
    for mode, kernel, per_call in ((True, "K1f", ENCODES_PER_CALL * LAUNCHES_PER_ENCODE),
                                   ("bi_grid", "K4f", ENCODES_PER_CALL * 3)):
        config = serving_config(use_pallas_lstm=mode)
        params = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
        live = OnlinePredictor(params, config, TARGETS, max_samples=T_RAW, device="cuda")
        with tempfile.TemporaryDirectory() as path:
            t0 = time.perf_counter()
            export_predictor(live, path)
            export_s = time.perf_counter() - t0
            loaded = load_exported_predictor(path)
            loaded(requests[0])  # warm-up
            # ---- the main path: counts reset just before, read just after ----
            reset_counts()
            outs = [loaded(x) for x in requests]
            counts = read_counts()
            # ------------------------------------------------------------------
        check_counts(f"exported predictor ({mode})", counts, {kernel: per_call * len(requests)})
        for x, out in zip(requests, outs):
            check(np.array_equal(out["tokens"], live(x)["tokens"]),
                  f"exported predictor ({mode}): tokens != the live predictor's")
        print(f"export ({mode}): exported and saved in {export_s:.1f} s; loaded in the same "
              f"process, {len(requests)} calls launched {counts[kernel]} {kernel} "
              f"({per_call} a call) through the program; tokens == the live predictor's")
        results[str(mode)] = {"counts": counts, "export_s": export_s}
    return results

# --------------------------------------------------------------------------
# 15-19. the MoE conformer, int8 serving, featurization and the raw-voltage
# session: main paths
# --------------------------------------------------------------------------

MOE = dict(moe_experts=8, moe_topk=2)
# the JAX package's MoE training cell (bench.py:303-320): capacity 1.25,
# dispatch groups of 512 steps, B=16 x T'=2048 (24576 raw samples)
MOE_TRAIN = dict(moe_capacity_factor=1.25, moe_group_size=512)
MOE_B, MOE_T = 16, 2048
MOE_TRIALS = 24
# the JAX package's featurization cell (bench.py:382-400): 10 s, 469
# channels, 3.2 kHz raw → 200 Hz
HG_RAW_RATE, HG_SECONDS = 3200.0, 10.0


def moe_config(dtype=torch.bfloat16, impl: str = "flash", **moe) -> Seq2SeqConfig:
    """The conformer serving model with an 8-expert top-2 MoE second FFN."""
    base = conformer_config(dtype, impl)
    return dataclasses.replace(base, conformer=dataclasses.replace(
        base.conformer, **MOE, **moe))


def moe_serving_phase() -> dict:
    """The headline conformer with ``moe_experts=8, moe_topk=2`` (no-drop),
    bf16: B=1 and B=256 x 1248 requests through ``OnlinePredictor`` under
    'fused' (K3f) and 'flash' (K2f), K5f on every other LayerNorm (the MoE
    FFN's included); the router aux loss of the B=256 encode finite; in f32
    both impls' tokens equal the plain (banded) path's."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    params = init_seq2seq(moe_config(), torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(10)
    single = rng.standard_normal((T_RAW, 469), dtype=np.float32)
    batch = rng.standard_normal((256, T_RAW, 469), dtype=np.float32)
    results = {}
    for impl, kernel in (("fused", "K3f"), ("flash", "K2f")):
        predictor = OnlinePredictor(params, moe_config(impl=impl), TARGETS, max_samples=T_RAW,
                                    device="cuda")
        predictor(single)  # warm-up
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        latencies = []
        for _ in range(3):
            out, dt = _timed(lambda: predictor(single))
            latencies.append(dt)
        b256, batch_s = _timed(lambda: predictor(batch))
        counts = read_counts()
        bodies = read_bodies()
        # --------------------------------------------------------------
        encodes = 4 * ENCODES_PER_CALL
        check_counts(f"MoE serving ({impl})", counts,
                     {kernel: encodes * nb, "K5f": encodes * nb * LN_PER_BLOCK[impl]})
        check_bodies(f"MoE serving ({impl}, bf16)", bodies, kernel, "tensor_core", counts[kernel])
        _check_response(out, 1, f"MoE {impl} single")
        _check_response(b256, 256, f"MoE {impl} batch")
        latency = float(np.median(latencies))
        prof = profile_call(f"MoE serving ({impl}) B=256", lambda: predictor(batch),
                            need=(kernel, "K5f"))
        results[impl] = {"counts": counts, "latency_s": latency, "batch_s": batch_s,
                         "profile_b256": prof}
        print(f"MoE serving ({impl}, bf16, E=8 top-2 no-drop): 4 predictor calls, "
              f"{counts[kernel]} {kernel} + {counts['K5f']} K5f launches, 0 of every other "
              f"kernel; B=1 {T_RAW} samples median {1e3 * latency:.2f} ms; B=256 "
              f"{1e3 * batch_s:.2f} ms = {256 / batch_s:.2f} sentences/s  [{gpu_line()}]")
    x, lengths = _cuda_batch(batch)
    with torch.inference_mode():
        *_, aux = encode(params, moe_config(), x, lengths, 0, return_aux=True)
    check(bool(torch.isfinite(aux)) and float(aux) > 0, f"MoE serving: moe_aux {float(aux)}")
    # f32: both kernel paths' tokens equal the plain path's
    plain = OnlinePredictor(params, moe_config(torch.float32, "banded"), TARGETS,
                            max_samples=T_RAW, device="cuda")
    want = [plain(x)["tokens"] for x in (single, batch[:8])]
    for impl in ("fused", "flash"):
        f32 = OnlinePredictor(params, moe_config(torch.float32, impl), TARGETS,
                              max_samples=T_RAW, device="cuda")
        for w, x in zip(want, (single, batch[:8])):
            check(np.array_equal(f32(x)["tokens"], w),
                  f"MoE f32 tokens ({impl}) != the plain path's")
    print(f"MoE serving f32: fused and flash tokens == the plain path's (B=1 and B=8); "
          f"moe_aux of the B=256 encode {float(aux):.6f}")
    results["moe_aux"] = float(aux)
    return results


def moe_training_phase() -> dict:
    """The JAX package's MoE cell through the segment runner: capacity
    1.25, groups of 512 steps, B=16 x T'=2048 (full-length trials), bf16,
    dropout on, 'flash': TRAIN_STEPS steps, each 4 K2f + 4 K2b-dq + 4
    K2b-dkv + 20 K5f + 20 K5b; the loss finite and falling, ``moe_aux`` > 0;
    step time and tokens/s."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    config = moe_config(**MOE_TRAIN)
    t_raw = MOE_T * config.decimation_factor
    p = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
    data = _random_corpus(config, MOE_TRIALS, t_raw)
    data["encoder_lengths"].fill_(t_raw)
    state = TrainState(p, tree_map(lambda t: t.detach().clone(), p), make_optimizer(p, 1e-3), 0)
    runner = make_segment_runner(config, PENALTIES, 0.99)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    subject = np.zeros((1,), np.int32)

    def step() -> tuple:
        nonlocal state
        idx = rng.permutation(MOE_TRIALS)[:MOE_B][None]
        state, metrics = runner(state, data, subject, idx, gen, 0)
        return float(metrics["loss_total"]), float(metrics["moe_aux"])

    losses = [step()]
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    bodies = read_bodies()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # ------------------------------------------------------------------
    want = TRAIN_STEPS * nb
    ln = want * LN_PER_BLOCK["flash"]
    check_counts("MoE training (flash)", counts,
                 {"K2f": want, "K2b-dq": want, "K2b-dkv": want, "K5f": ln, "K5b": ln})
    for k in ("K2f", "K2b-dq", "K2b-dkv"):
        check_bodies("MoE training (bf16)", bodies, k, "tensor_core", counts[k])
    total = [t for t, _ in losses]
    check(all(np.isfinite(total)), f"MoE training: non-finite loss {losses}")
    check(total[-1] < total[0], f"MoE training: loss did not fall: {losses}")
    check(all(a > 0 and np.isfinite(a) for _, a in losses), f"MoE training: moe_aux {losses}")
    ms = 1e3 * float(np.mean(step_s))
    tokens_per_s = MOE_B * MOE_T / (ms / 1e3)
    print(f"MoE training (E=8 top-2, capacity 1.25, groups of 512, 'flash', B={MOE_B} x "
          f"T'={MOE_T}, bf16, dropout on): (total, moe_aux) "
          + ", ".join(f"({t:.4f}, {a:.5f})" for t, a in losses)
          + f"; per step {nb} K2f + {nb} K2b-dq + {nb} K2b-dkv + {nb * 5} K5f + {nb * 5} K5b; "
          f"steps " + ", ".join(f"{1e3 * x:.2f}" for x in step_s)
          + f" ms, mean {ms:.2f} ms = {tokens_per_s:.0f} encoder tokens/s; peak device memory "
          f"{peak_gib:.2f} GiB (corpus of {MOE_TRIALS} trials included)  [{gpu_line()}]")
    prof = profile_call(f"MoE training step B={MOE_B} T'={MOE_T}", step,
                        need=("K2f", "K2b-dq", "K2b-dkv", "K5f", "K5b"))
    return {"counts": counts, "bodies": bodies, "ms": ms, "tokens_per_s": tokens_per_s,
            "losses": losses, "peak_gib": peak_gib, "profile": prof}


def int8_serving_phase(params) -> dict:
    """``quantize='int8'`` over the session phase's model: the int8 GEMM's
    int32 sums against a float64 product on the card (the conformer's
    shapes, K=100 and 16 rows or fewer included); a B=256 encode of
    ``quantize_conformer_params`` against the float encode (JAX's bounds:
    cosine > 0.999, max abs err < 5 % of the max); bf16 sessions under
    'flash' and 'fused' (both run K2f: K3f reads the float wqkv), per-chunk
    latency; in f32 the session's and the pool's endpoints equal the
    offline decode with the same quantized weights."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    g = torch.Generator().manual_seed(11)
    gemm = []
    for M, K, N in ((1, 100, 384), (16, 100, 384), (17, 384, 1152), (256 * T_STEPS, 100, 384),
                    (256 * T_STEPS, 384, 1152), (256 * T_STEPS, 1536, 384)):
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
        a[0], b[:, 0] = 127, -127
        got = int8_mm(a.cuda(), b.cuda())
        want = (a.cuda().double() @ b.cuda().double()).to(torch.int32)
        check(torch.equal(got, want), f"int8 GEMM ({M}x{K}x{N}): int32 sums != float64 product")
        gemm.append((M, K, N))
    M, K, N = 256 * T_STEPS, 384, 1152
    a = torch.randint(-127, 128, (M, K), device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), device="cuda", dtype=torch.int8)
    bq = _column_major(b)
    abf, bbf = a.to(torch.bfloat16), b.to(torch.bfloat16)
    # in turns; the weight as stored (column-major) and row-major
    fns = {"int8": lambda: torch._int_mm(a, bq), "int8_row_major": lambda: torch._int_mm(a, b),
           "bf16": lambda: abf @ bbf}
    gemm_ms = _in_turns(fns, 20, ["int8", "int8_row_major", "bf16", "bf16", "int8_row_major",
                                  "int8"])
    print(f"int8 GEMM on the card: int32 sums == float64 product at (M, K, N) {gemm}; at "
          f"{M}x{K}x{N}, in turns: int8 {gemm_ms['int8']:.4f} ms (weight column-major), "
          f"{gemm_ms['int8_row_major']:.4f} ms (row-major), bf16 {gemm_ms['bf16']:.4f} ms  "
          f"[{gpu_line()}]")
    # the B=256 encode of the quantized encoder against the float one
    enc = params["encoder"]["conformer"]
    qenc = quantize_conformer_params(enc)
    ccfg = ctc_config().conformer
    x = torch.randn((256, T_STEPS, 100), generator=torch.Generator(device="cuda").manual_seed(12),
                    device="cuda").to(torch.bfloat16)
    reset_counts()
    launches = int8_mm.launches
    with torch.inference_mode():
        qout, _ = conformer_encode(qenc, ccfg, x, compute_dtype=torch.bfloat16)
        counts = read_counts()
        launches = int8_mm.launches - launches
        ref, _ = conformer_encode(enc, ccfg, x, compute_dtype=torch.bfloat16)
    check_counts("int8 encode (flash)", counts, {"K2f": nb, "K5f": nb * LN_PER_BLOCK["flash"]})
    # in_proj, then per block ffn1 (2), wqkv, wo, pw1, pw2, ffn2 (2)
    check(launches == 1 + 8 * nb, f"int8 encode: {launches} int8 GEMMs, expected {1 + 8 * nb}")
    r, o = ref.float(), qout.float()
    cos = float((r * o).sum() / (r.norm() * o.norm()))
    rel_max = float((o - r).abs().max() / r.abs().max())
    check(cos > 0.999 and rel_max < 0.05,
          f"int8 encode vs float: cosine {cos:.6f}, max abs err / max {rel_max:.4f}")
    enc_ms = {"int8": cuda_ms(lambda: conformer_encode(qenc, ccfg, x, compute_dtype=torch.bfloat16), 5),
              "bf16": cuda_ms(lambda: conformer_encode(enc, ccfg, x, compute_dtype=torch.bfloat16), 5)}
    print(f"int8 encode B=256 T'={T_STEPS} bf16 'flash': {launches} int8 GEMMs, {counts['K2f']} K2f "
          f"+ {counts['K5f']} K5f; vs the float encode cosine {cos:.6f}, max abs err {rel_max:.4f} "
          f"of the max; {enc_ms['int8']:.3f} ms vs {enc_ms['bf16']:.3f} ms float  [{gpu_line()}]")
    # bf16 sessions: 'fused' gives way to 'flash' under int8
    rng = np.random.default_rng(13)
    rec = rng.standard_normal((4 * T_RAW, 469), dtype=np.float32)
    results = {"gemm_ms": gemm_ms, "encode_ms": enc_ms, "cos": cos, "rel_max": rel_max}
    for impl in ("flash", "fused"):
        session = StreamingConformerSession(params, ctc_config(impl=impl), TARGETS,
                                            quantize="int8", device="cuda")
        session.push(rec[:SPC])  # warm-up
        session.reset()
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        chunk_s = []
        for lo in range(0, len(rec), SPC):
            _, dt = _timed(lambda: session.push(rec[lo: lo + SPC]))
            chunk_s.append(dt)
        out = session.endpoint()
        counts = read_counts()
        bodies = read_bodies()
        # --------------------------------------------------------------
        encodes = len(chunk_s)
        check_counts(f"int8 session ({impl})", counts,
                     {"K2f": encodes * nb, "K5f": encodes * nb * LN_PER_BLOCK["flash"]})
        check_bodies(f"int8 session ({impl}, bf16)", bodies, "K2f", "tensor_core", counts["K2f"])
        check(out["tokens"].shape == (1, 20) and np.isfinite(out["encoder_outputs"]).all(),
              f"int8 session ({impl}): endpoint")
        med = 1e3 * float(np.median(chunk_s))
        results[impl] = {"counts": counts, "chunk_ms": med, "encodes": encodes}
        print(f"int8 session ({impl} → flash, bf16, B=1): {encodes} window encodes, "
              f"{counts['K2f']} K2f + {counts['K5f']} K5f, 0 K3f; per chunk of {SPC} samples "
              f"median {med:.3f} ms  [{gpu_line()}]")
    # f32: the session's and the pool's endpoints against the offline decode
    # with the same quantized weights (the contract of tests/test_quantize.py)
    f32 = ctc_config(torch.float32)
    qparams = quantize_conformer_params(params)
    utt = rng.standard_normal((1000, 469), dtype=np.float32)
    session = StreamingConformerSession(params, f32, TARGETS, quantize="int8", device="cuda")
    pool = StreamingSessionPool(params, f32, TARGETS, capacity=2, quantize="int8", device="cuda")
    slot = pool.add()
    for pkt in _ragged(utt, rng):
        session.push(pkt)
        pool.push(slot, pkt)
    offline = _stream_offline(qparams, f32, utt)
    check(np.array_equal(session.endpoint()["tokens"], offline),
          "int8 session f32: endpoint != the quantized offline decode")
    dense = _stream_offline(qparams, ctc_config(torch.float32, "dense"), utt)
    check(np.array_equal(pool.endpoint(slot)["tokens"], dense),
          "int8 pool f32: endpoint != the quantized offline decode")
    print("int8 f32: session and pool endpoints == the offline greedy_decode with the same "
          "quantized weights")
    return results


def featurization_phase() -> dict:
    """``extract_high_gamma`` on the JAX package's featurization cell (10 s,
    469 channels, 3.2 kHz → 200 Hz, zscore='none') on the card against the
    same chain on the CPU (f32), and its realtime factor (seconds of signal
    per second); int16 input too."""
    cfg = HighGammaConfig(raw_rate=HG_RAW_RATE, out_rate=200.0, zscore="none", input_scale=1e-3)
    raw = np.random.default_rng(14).standard_normal(
        (int(HG_SECONDS * HG_RAW_RATE), 469), dtype=np.float32)
    ints = np.clip(raw * 1e3, -32768, 32767).astype(np.int16)
    x = torch.from_numpy(raw).cuda()
    xi = torch.from_numpy(ints).cuda()
    with torch.inference_mode():
        got = extract_high_gamma(x, cfg)
        got_i = extract_high_gamma(xi, cfg)
        times = [_timed(lambda: extract_high_gamma(x, cfg))[1] for _ in range(6)][1:]
        ms_dev = cuda_ms(lambda: extract_high_gamma(x, cfg), 5)
    err, _ = compare("featurization card vs CPU", got.cpu(),
                     torch.from_numpy(extract_high_gamma_np(raw, cfg, device="cpu")),
                     TOL[torch.float32])
    err_i, _ = compare("featurization int16 card vs CPU", got_i.cpu(),
                       torch.from_numpy(extract_high_gamma_np(ints, cfg, device="cpu")),
                       TOL[torch.float32])
    check(tuple(got.shape) == (int(HG_SECONDS * 200), 469), f"featurization: {tuple(got.shape)}")
    s = float(np.median(times))
    n_fft = _next_fast_len(len(raw) + 2 * cfg.pad_samples)
    print(f"featurization (10 s x 469 channels at 3.2 kHz → 200 Hz, {cfg.num_bands} bands, "
          f"n_fft {n_fft}): card vs CPU max abs err {err:.3e} (int16 {err_i:.3e}); median wall "
          f"{1e3 * s:.3f} ms, device {ms_dev:.3f} ms (CUDA events) = realtime x "
          f"{HG_SECONDS / s:.1f}  [{gpu_line()}]")
    return {"ms": 1e3 * s, "device_ms": ms_dev, "realtime_x": HG_SECONDS / s, "err": err,
            "err_int16": err_i}


def raw_session_phase(params) -> dict:
    """``RawVoltageSession`` over the session phase's CTC-headed conformer,
    f32, 'flash': synthetic int16 raw voltage at 3.2 kHz (an envelope at
    200 Hz through ``synthesize_raw_from_envelope``), calibration statistics
    from ``calibrate_high_gamma``, ragged packets of 50-200 ms; ``decode()``
    twice mid-stream (equal, the stream intact); ``endpoint()`` tokens equal
    the offline decode of ``(extract_high_gamma_np(raw) - mean) / std``;
    per-push and ``partial()`` medians."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    cfg = HighGammaConfig(raw_rate=HG_RAW_RATE, out_rate=200.0, zscore="none", input_scale=1e-3)
    rng = np.random.default_rng(15)
    t = np.arange(T_RAW)[:, None] / 200.0
    envelope = (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t + np.arange(469)[None] / 7.0)).astype(
        np.float32)
    volts = synthesize_raw_from_envelope(envelope, cfg, rng)
    raw = np.clip(volts / cfg.input_scale, -32768, 32767).astype(np.int16)
    calib = np.clip(synthesize_raw_from_envelope(envelope[:400], cfg, rng) / cfg.input_scale,
                    -32768, 32767).astype(np.int16)
    stats = calibrate_high_gamma([calib], cfg, device="cuda")
    feats = (extract_high_gamma_np(raw, cfg, device="cuda") - stats[0]) / np.maximum(stats[1], 1e-6)
    config = ctc_config(torch.float32)
    offline = _stream_offline(params, config, feats)
    session = RawVoltageSession(
        StreamingConformerSession(params, config, TARGETS, phoneme_list=_demo_phonemes(),
                                  device="cuda"), cfg, stats=stats)
    stream = session.session.stream
    pushes = 0
    stream_push = stream.push

    def counted_push(*args, **kwargs):
        nonlocal pushes
        pushes += 1
        return stream_push(*args, **kwargs)

    stream.push = counted_push
    cuts = np.cumsum(rng.integers(int(0.05 * HG_RAW_RATE), int(0.2 * HG_RAW_RATE) + 1,
                                  size=len(raw) // 160))
    packets = np.split(raw, cuts[cuts < len(raw)])
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    push_s, partial_s, mids = [], [], []
    for i, pkt in enumerate(packets):
        _, dt = _timed(lambda: session.push(pkt))
        push_s.append(dt)
        if session.session._enc_outs:
            _, dt = _timed(session.partial)
            partial_s.append(dt)
        if i in (len(packets) // 3, len(packets) // 2):
            a, b = session.decode(), session.decode()
            check(np.array_equal(a["tokens"], b["tokens"]), "raw session: decode() repeats")
            mids.append(a["tokens"])
    out = session.endpoint()
    counts = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    check_counts("raw session (flash)", counts,
                 {"K2f": pushes * nb, "K5f": pushes * nb * LN_PER_BLOCK["flash"]})
    check_bodies("raw session (f32)", bodies, "K2f", "cuda_core", counts["K2f"])
    check(np.array_equal(out["tokens"], offline),
          "raw session: endpoint != offline decode of the calibrated offline features")
    med = {k: 1e3 * float(np.median(v)) for k, v in (("push", push_s), ("partial", partial_s))}
    print(f"raw-voltage session (int16 at 3.2 kHz → {T_RAW} frames at 200 Hz, f32, 'flash', "
          f"{len(packets)} packets of 50-200 ms): {pushes} window encodes, {counts['K2f']} K2f + "
          f"{counts['K5f']} K5f; decode() mid-stream repeats; endpoint tokens == the offline "
          f"decode of the calibrated offline features; per push median {med['push']:.3f} ms, "
          f"partial() median {med['partial']:.3f} ms  [{gpu_line()}]")
    return {"counts": counts, "bodies": bodies, "encodes": pushes, "push_ms": med["push"],
            "partial_ms": med["partial"], "packets": len(packets)}


# --------------------------------------------------------------------------
# 21. the rest of the trainer, conformer export and cuDNN's TF32 default:
#     main paths
# --------------------------------------------------------------------------

# the JAX benchmark's layer widths (bench.py:46-63) on a two-subject demo
# experiment: a 16x16 donor and a 22x22 target (484 channels)
XFER_SIZES = {"encoder_embedding": [100], "encoder_rnn": [400, 400, 400],
              "encoder_1_projection": [225], "decoder_embedding": [150],
              "decoder_rnn": [800], "decoder_projection": []}
DEMO_SIZES = {"encoder_embedding": [32], "encoder_rnn": [64, 64], "encoder_1_projection": [32],
              "decoder_embedding": [24], "decoder_rnn": [96], "decoder_projection": []}
XFER_GRIDS = {1: (16, 16), 2: (22, 22)}
# 32 sentences a block: 128 training trials for the target (4 blocks), 192
# for the donor (all 6 blocks)
XFER_SENTENCES = 32
XFER_SN = {"compute_dtype": "bfloat16", "use_pallas_lstm": True, "batch_size": 64,
           "learning_rate": 1e-3, "max_dec_len": 10, "warmup_steps": 4,
           "lr_schedule": "warmup_cosine", "checkpoint_every_assessment": True}
# the curriculum's epochs: donor training, target pretraining (frozen
# core), target training + posttraining
CURRICULUM = dict(pretraining=2, training=2, posttraining=2)


def transfer_experiment(root: str) -> str:
    return make_demo_experiment(
        f"{root}/xfer", subject_ids=(1, 2), grid_sizes=XFER_GRIDS, layer_sizes=XFER_SIZES,
        num_sentences_per_block=XFER_SENTENCES, assessment_epoch_interval=2,
    )


def transfer_trainer(manifest: str, **sn) -> MultiSubjectTrainer:
    return MultiSubjectTrainer(manifest, [1, 2], VERBOSE=False, device="cuda",
                               SN_kwargs={**XFER_SN, **sn})


def _fit_steps(trainer: MultiSubjectTrainer, subject_subset, epochs: int) -> int:
    counts = trainer.packed_dataset("training").num_trials
    subjects = range(len(counts)) if subject_subset is None else subject_subset
    return epochs * sum(-(-int(counts[s]) // trainer.batch_size) for s in subjects if counts[s])


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def curriculum_phase(trainer: MultiSubjectTrainer, logdir: str) -> dict:
    """``sequential_transfer_learn`` at full width, bf16, dropout on, the
    warmup-cosine schedule, summaries and a checkpoint every assessment: K1b
    launches 6 times a step in every fit (K1f at least as often); the frozen
    pretraining fit leaves every encoder, aux and decoder leaf and the
    donor's subnet row bit-identical and moves the target's row; the epochs
    are the curriculum's sum; the event file holds the loss at every
    interval and the WERs at every assessment."""
    fits = []
    fit = trainer.fit

    def spy(**kw):
        before = read_counts()
        frozen = kw.get("train_vars_scope") is not None
        leaves = [t.detach().clone() for t in tree_leaves(trainer.state.params)] if frozen else None
        t0 = time.perf_counter()
        history = fit(**kw)
        torch.cuda.synchronize()
        after = read_counts()
        fits.append({
            "kw": kw, "s": time.perf_counter() - t0, "history": history,
            "before": leaves, "after": [t.detach().clone() for t in
                                        tree_leaves(trainer.state.params)] if frozen else None,
            "counts": {k: after[k] - before[k] for k in after},
            "steps": _fit_steps(trainer, kw.get("subject_subset"), kw["num_epochs"]),
            "rates": list(trainer.state.opt_state.learning_rates),
        })
        return history

    trainer.fit = spy
    try:
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        t0 = time.perf_counter()
        history = trainer.sequential_transfer_learn(**CURRICULUM)
        total_s = time.perf_counter() - t0
        counts = read_counts()
        bodies = read_bodies()
        # ------------------------------------------------------------------
    finally:
        del trainer.fit
    check(all(v == 0 for k, v in counts.items() if k not in ("K1f", "K1b")),
          f"curriculum: launches {counts}")
    check_bodies("curriculum (bf16)", bodies, "K1f", "cluster", counts["K1f"])
    check_bodies("curriculum (bf16)", bodies, "K1b", "cluster", counts["K1b"])
    per_step = 2 * len(trainer.net_config.rnn_sizes)
    for f in fits:
        c = f["counts"]
        check(c["K1b"] == per_step * f["steps"] and c["K1f"] >= c["K1b"],
              f"curriculum fit {f['kw']}: K1b {c['K1b']}, K1f {c['K1f']} in {f['steps']} steps")
        check(f["rates"][0] == 0.0 and max(f["rates"]) > 0,
              f"curriculum fit {f['kw']}: learning rates {f['rates'][:6]}")
    frozen = [f for f in fits if f["kw"].get("train_vars_scope")]
    check(len(fits) == 3 and len(frozen) == 1, f"curriculum: fits {[f['kw'] for f in fits]}")
    leaves_before, leaves_after = frozen[0]["before"], frozen[0]["after"]
    paths = list(_shape_tree(trainer.state.params))  # in tree_leaves order
    moved = []
    for path, b, a in zip(paths, leaves_before, leaves_after):
        if path.startswith("subnet/"):
            check(torch.equal(a[0], b[0]), f"frozen fit: the donor's {path} row moved")
            moved.append(not torch.equal(a[1], b[1]))
        else:
            check(torch.equal(a, b), f"frozen fit: {path} is not bit-identical")
    check(all(moved), "frozen fit: the target's subnet rows did not all move")
    want_epochs = 2 * CURRICULUM["training"] + CURRICULUM["pretraining"] + CURRICULUM["posttraining"]
    check(int(trainer.state.epoch) == want_epochs,
          f"curriculum: epoch {trainer.state.epoch}, expected {want_epochs}")
    # the event file: the loss at every interval, the WERs at every assessment
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    by_step: dict = {}
    for event in iter_events(path):
        by_step.setdefault(event["step"], {}).update(event.get("scalars", {}))
    assessed = sorted(int(e) for f in fits for e in f["history"])
    intervals = sorted(s for s in by_step if s)
    check(intervals == sorted({*assessed, CURRICULUM["training"] + CURRICULUM["pretraining"]}),
          f"summaries: steps {intervals}, assessments {assessed}")
    for step in intervals:
        check(np.isfinite(by_step[step].get("loss/total", np.nan)),
              f"summaries: no finite loss/total at epoch {step}")
    for step in assessed:
        check({"training/word_error_rate", "validation/word_error_rate"} <= set(by_step[step]),
              f"summaries: no WER scalars at assessment epoch {step}")
    wers = {e: (s["training"]["word_error_rate"], s["validation"]["word_error_rate"])
            for e, s in history.items()}
    check(all(np.isfinite(v).all() for v in wers.values()), f"curriculum: WERs {wers}")
    steps = sum(f["steps"] for f in fits)
    print(f"curriculum (sequential_transfer_learn, 2 subjects 256 / 484 channels, 3x400 biLSTM, "
          f"bf16, B={trainer.batch_size}, warmup-cosine): epochs {trainer.state.epoch}, {steps} "
          f"steps in {total_s:.2f} s; fits "
          + ", ".join(f"{f['kw'].get('subject_subset')}"
                      f"{' frozen' if f['kw'].get('train_vars_scope') else ''}: "
                      f"{f['steps']} steps {f['s']:.2f} s, K1b {f['counts']['K1b']}, "
                      f"K1f {f['counts']['K1f']}" for f in fits)
          + f"; frozen fit: core bit-identical, donor row unchanged; (train, val) WER by "
          f"assessment {wers}; events at epochs {intervals}  [{gpu_line()}]")
    return {"counts": counts, "bodies": bodies, "total_s": total_s, "steps": steps,
            "fit_s": [f["s"] for f in fits], "fit_counts": [f["counts"] for f in fits],
            "wers": wers}


def rollback_phase(trainer: MultiSubjectTrainer) -> dict:
    """``learning_rate = 1e18`` on the trained trainer: ``fit`` raises
    ``FloatingPointError`` naming the restored epoch, and the state is the
    newest checkpoint bit for bit, every leaf finite."""
    newest = trainer.restore_epoch
    saved = load_checkpoint(trainer._ckpt_path(newest), "cuda")
    lr, trainer.learning_rate = trainer.learning_rate, 1e18
    message = None
    t0 = time.perf_counter()
    try:
        trainer.fit(num_epochs=2, assess=False)
    except FloatingPointError as err:
        message = str(err)
    finally:
        trainer.learning_rate = lr
    rollback_s = time.perf_counter() - t0
    check(message is not None and f"restored checkpoint at epoch {newest}" in message,
          f"rollback: {message!r}")
    check(int(trainer.state.epoch) == newest and _equal_trees(trainer.state.params, saved["params"])
          and _equal_trees(trainer.state.ema, saved["ema"]),
          "rollback: the state is not the newest checkpoint")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(trainer.state.params)),
          "rollback: non-finite leaves")
    print(f"NaN rollback: learning rate 1e18 → {message!r} in {rollback_s:.2f} s; state == "
          f"ckpt-{newest}.pt bit for bit, all finite  [{gpu_line()}]")
    return {"s": rollback_s, "epoch": newest}


def _encodes(trainer: MultiSubjectTrainer, partitions) -> int:
    return sum(int(n > 0) for p in partitions for n in trainer.packed_dataset(p).num_trials)


def _same_assessment(got: dict, want: dict) -> bool:
    return all(got[p]["word_error_rate"] == want[p]["word_error_rate"]
               and got[p]["hypotheses"] == want[p]["hypotheses"] for p in want)


def recovery_phase(manifest: str, source: MultiSubjectTrainer) -> dict:
    """A trainer built at the demo widths (2x64, decoder 96) assesses the
    full-width checkpoint: its ``net_config`` is rebuilt to 3x400 / 800,
    each encode launches K1f 6 times, and the WERs and hypotheses equal the
    source trainer's EMA assessment."""
    parts = ("training", "validation")
    want = source.assess(parts)
    small = transfer_trainer(manifest, layer_sizes=DEMO_SIZES, tf_summaries_dir=None,
                             checkpoint_every_assessment=False)
    check(small.net_config.rnn_sizes == (64, 64), f"recovery: built {small.net_config.rnn_sizes}")
    epoch = source.restore_epoch
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    got = small.assess_saved_model(epoch, partitions=parts)
    assess_s = time.perf_counter() - t0
    counts = read_counts()
    # ------------------------------------------------------------------
    cfg = small.net_config
    check(cfg.rnn_sizes == tuple(XFER_SIZES["encoder_rnn"])
          and cfg.dec_rnn_sizes == tuple(XFER_SIZES["decoder_rnn"]) and cfg == source.net_config,
          f"recovery: rebuilt to {cfg}")
    encodes = _encodes(small, parts)
    check_counts("recovery assessment", counts, {"K1f": 6 * encodes})
    check(_same_assessment(got, want), "recovery: the assessment differs from the source's")
    print(f"architecture recovery: built at 2x64 / 96, assess_saved_model(ckpt-{epoch}.pt) rebuilt "
          f"3x400 / 800 in {assess_s:.2f} s (rebuild + {encodes} encodes, K1f {counts['K1f']}); "
          f"WERs == the source's EMA assessment "
          f"{[want[p]['word_error_rate'] for p in parts]}  [{gpu_line()}]")
    return {"counts": counts, "s": assess_s, "want": want}


def tf1_phase(manifest: str, source: MultiSubjectTrainer, want: dict) -> dict:
    """The full-width parameters as variables in the reference's TF1
    grammar (``tf1_variables_from_params``; a mapping: tensorflow is not
    needed) imported into a fresh demo-width trainer with
    ``rebuild='auto'``: every leaf and EMA leaf equal bit for bit, the same
    assessment."""
    variables = tf1_variables_from_params(source.state.params, source.net_config.conv_strides,
                                          source.subject_ids, source.state.ema)
    fresh = transfer_trainer(manifest, layer_sizes=DEMO_SIZES, tf_summaries_dir=None,
                             checkpoint_every_assessment=False)
    t0 = time.perf_counter()
    report = fresh.import_tf1_checkpoint(variables)
    import_s = time.perf_counter() - t0
    check(report["skipped"] == [] and len(report["imported"]) == len(variables),
          f"TF1 import: {len(report['skipped'])} skipped")
    check(fresh.net_config == source.net_config, "TF1 import: net_config not rebuilt")
    check(_equal_trees(fresh.state.params, source.state.params)
          and _equal_trees(fresh.state.ema, source.state.ema), "TF1 import: leaves differ")
    got = fresh.assess(tuple(want))
    check(_same_assessment(got, want), "TF1 import: the assessment differs")
    print(f"TF1 import: {len(variables)} variables of the reference's grammar into a 2x64 trainer, "
          f"rebuilt to 3x400 / 800 and imported in {import_s:.2f} s; every leaf equal bit for bit, "
          f"the same assessment  [{gpu_line()}]")
    return {"s": import_s, "variables": len(variables)}


def analysis_phase(trainer: MultiSubjectTrainer) -> dict:
    """``get_saliencies`` (the decoder loss's input gradient, bf16): 6 K1f
    and 6 K1b a subject; ``get_internal_activations``: 6 K1f; in f32 the
    kernel path equals the plain path at the f32 tolerance (saliencies
    normwise: gradients summed in another order)."""
    S = len(trainer.ecog_subjects)
    val = trainer.packed_dataset("validation")
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    sal = trainer.get_saliencies()
    sal_s = time.perf_counter() - t0
    sal_counts = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    act = trainer.get_internal_activations()
    act_s = time.perf_counter() - t0
    act_counts = read_counts()
    # ------------------------------------------------------------------
    check_counts("saliencies", sal_counts, {"K1f": 6 * S, "K1b": 6 * S})
    check_counts("internal activations", act_counts, {"K1f": 6})
    n_val = int(val.num_trials.sum())
    check(sal.shape == (n_val,) + val.encoder_inputs.shape[2:] and np.isfinite(sal).all()
          and np.abs(sal).max() > 0, f"saliencies: {sal.shape}")
    check(all(np.isfinite(v).all() for k, v in act.items() if k != "aux_targets"),
          "activations: non-finite values")
    cfg = trainer.net_config
    f32 = {}
    try:
        for name, pallas in (("kernel", True), ("plain", False)):
            trainer.net_config = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                                     use_pallas_lstm=pallas)
            f32[name] = (trainer.get_saliencies(), trainer.get_internal_activations())
    finally:
        trainer.net_config = cfg
    sal_err, _ = compare("saliencies f32 kernel vs plain", torch.from_numpy(f32["kernel"][0]),
                         torch.from_numpy(f32["plain"][0]), TOL[torch.float32], normwise=True)
    act_err = 0.0
    for key in ("convolved_inputs", "encoder_outputs", "final_state_h", "final_state_c"):
        err, _ = compare(f"activations f32 kernel vs plain: {key}",
                         torch.from_numpy(f32["kernel"][1][key]),
                         torch.from_numpy(f32["plain"][1][key]), TOL[torch.float32])
        act_err = max(act_err, err)
    print(f"saliencies ({n_val} validation trials, bf16): {sal_s:.2f} s, K1f {sal_counts['K1f']} + "
          f"K1b {sal_counts['K1b']}; internal activations {act_s:.2f} s, K1f {act_counts['K1f']}; "
          f"f32 kernel vs plain: saliency max abs err {sal_err:.3e} (normwise), activations "
          f"{act_err:.3e}  [{gpu_line()}]")
    return {"sal_counts": sal_counts, "act_counts": act_counts, "sal_s": sal_s, "act_s": act_s,
            "sal_err": sal_err, "act_err": act_err}


def lazy_shard_phase(manifest: str) -> dict:
    """``fit`` of a fresh full-width trainer with ``max_host_trials`` a third
    of the largest subject's training trials (shards re-read from the
    records, the next one read and uploaded by the prefetch worker), against
    the same fit with ``max_device_trials`` (the resident corpus sliced):
    the same seeds and shards; final parameters within the bf16 tolerance,
    K1b 6 times a step in both."""
    runs = {}
    for key in ("max_host_trials", "max_device_trials"):
        trainer = transfer_trainer(manifest, tf_summaries_dir=None,
                                   checkpoint_every_assessment=False)
        shard = int(trainer.packed_dataset("training").num_trials.max()) // 3
        trainer.SN_kwargs[key] = shard
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(num_epochs=2, assess=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        # ------------------------------------------------------------------
        runs[key] = {"trainer": trainer, "s": fit_s, "counts": counts, "shard": shard}
    host, dev = runs["max_host_trials"], runs["max_device_trials"]
    check(host["counts"] == dev["counts"] and host["counts"]["K1b"] > 0
          and host["counts"]["K1b"] % 6 == 0, f"lazy shards: launches {host['counts']} / "
          f"{dev['counts']}")
    err = max(float((a.detach().float() - b.detach().float()).abs().max()) for a, b in zip(
        tree_leaves(host["trainer"].state.params), tree_leaves(dev["trainer"].state.params)))
    for a, b in zip(tree_leaves(host["trainer"].state.params),
                    tree_leaves(dev["trainer"].state.params)):
        compare("lazy vs sliced shards: parameters", a, b, TOL[torch.bfloat16])
    print(f"lazy shards: shards of {host['shard']} trials a subject, 2 epochs: max_host_trials "
          f"{host['s']:.2f} s, max_device_trials {dev['s']:.2f} s (K1b {host['counts']['K1b']} "
          f"each); final parameters max abs diff {err:.3e}  [{gpu_line()}]")
    return {"counts": host["counts"], "host_s": host["s"], "device_s": dev["s"], "err": err,
            "shard": host["shard"]}


# (name, impl, MoE fields, blocks): tracing time grows with the blocks, so
# every family but 'flash' (whose program the TF32 check reads) is
# exported at 2 of the headline's 4 blocks (a depth cut; the widths are the
# headline's)
EXPORT_FAMILIES = (("flash", "flash", {}, 4), ("fused", "fused", {}, 2),
                   ("moe", "fused", MOE, 2),
                   ("moe_capacity", "flash", {**MOE, "moe_capacity_factor": 1.25}, 2))
# tokens an exported predictor decodes: tracing the decode loop is most of
# an export's time (a depth cut; the widths are the headline's)
EXPORT_DEC_LEN = 6


def conformer_export_phase() -> dict:
    """``export_predictor`` of the headline conformer under 'flash' and
    'fused' and of its MoE (no-drop; capacity 1.25, a group a row), f32,
    decoding ``EXPORT_DEC_LEN`` tokens, at the blocks of
    ``EXPORT_FAMILIES``, loaded back: calls at B=1, 17 and 256 (B·T' from
    104 to 26624, across the depthwise conv's eager crossover at 4096)
    launch per encode a K2f or K3f a block and its K5f through the
    program, two encodes a call; tokens equal the live predictor's.
    Returns the 'flash' program too (the TF32 check's)."""
    rng = np.random.default_rng(21)
    batches = [rng.standard_normal((B, T_RAW, 469), dtype=np.float32) for B in (1, 17, 256)]
    results, programs = {}, {}
    for name, impl, moe, nb in EXPORT_FAMILIES:
        config = conformer_config(torch.float32, impl)
        config = dataclasses.replace(config, max_dec_len=EXPORT_DEC_LEN, conformer=dataclasses.replace(
            config.conformer, **moe, num_blocks=nb))
        params = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
        live = OnlinePredictor(params, config, TARGETS, max_samples=T_RAW, device="cuda")
        kernel = {"flash": "K2f", "fused": "K3f"}[impl]
        with tempfile.TemporaryDirectory() as path:
            t0 = time.perf_counter()
            export_predictor(live, path)
            export_s = time.perf_counter() - t0
            loaded = load_exported_predictor(path)
        loaded(batches[0])  # warm-up
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        outs = [loaded(x) for x in batches]
        counts = read_counts()
        # ------------------------------------------------------------------
        encodes = ENCODES_PER_CALL * len(batches)
        check_counts(f"exported {name}", counts,
                     {kernel: encodes * nb, "K5f": encodes * nb * LN_PER_BLOCK[impl]})
        for x, out in zip(batches, outs):
            tokens, probs = out["tokens"], out["probabilities"]
            check(tokens.shape == probs.shape == (x.shape[0], EXPORT_DEC_LEN)
                  and bool(np.isfinite(probs).all()), f"exported {name}: {tokens.shape}")
            check(np.array_equal(out["tokens"], live(x)["tokens"]),
                  f"exported {name} B={x.shape[0]}: tokens != the live predictor's")
        print(f"export ({name}, f32): exported and saved in {export_s:.1f} s; B=1, 17, 256 "
              f"through the program: {counts[kernel]} {kernel} + {counts['K5f']} K5f "
              f"({nb} {kernel} an encode); tokens == the live predictor's  [{gpu_line()}]")
        results[name] = {"counts": counts, "export_s": export_s}
        if name == "flash":
            programs = {"loaded": loaded, "params": params, "config": config}
    return results, programs


def tf32_phase(flash: dict) -> dict:
    """With cuDNN's default flags (TF32 allowed in convolutions, matmuls in
    full f32), just for this check: an f32 conformer encode at B=256,
    T'=104 on the card against the same encode on the CPU, and the f32
    exported 'flash' program at B=256 against the CPU predictor, both at
    f32 rtol 1e-4 / atol 1e-5; the run's settings (TF32 off) for
    comparison, and a bare f32 depthwise ``F.conv1d`` at the conformer's
    shape against float64 under both."""
    config, params = flash["config"], flash["params"]
    rng = np.random.default_rng(32)
    x = rng.standard_normal((256, T_RAW, 469), dtype=np.float32)
    lengths = torch.full((256,), T_RAW, dtype=torch.int32)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    with torch.inference_mode():
        # the predictor's function (serve._predict) from one encode on the CPU
        want, final, enc_lengths = encode(cpu_params, config, torch.from_numpy(x), lengths, 0)
        want_tokens = decode_from_encoder(cpu_params, config, want, final, enc_lengths)
        logits = decoder_teacher_forcing(cpu_params, config, final, want_tokens, enc_out=want,
                                         enc_lengths=enc_lengths)
        want_probs = torch.gather(torch.softmax(logits, dim=-1), -1,
                                  want_tokens.long().T[..., None])[..., 0].T
    D, K = HEADLINE_CONFORMER["model_dim"], HEADLINE_CONFORMER["conv_kernel"]
    g = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((256, D, T_STEPS + K - 1), generator=g, device="cuda")
    w = torch.randn((D, 1, K), generator=g, device="cuda")
    conv_want = torch.nn.functional.conv1d(h.double(), w.double(), groups=D)
    run_flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    out = {}
    try:
        for label, flags in (("default", (True, False)), ("tf32_off", run_flags)):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            xc, lc = _cuda_batch(x)
            with torch.inference_mode():
                got = encode(params, config, xc, lc, 0)[0].cpu()
                conv = torch.nn.functional.conv1d(h, w, groups=D)
            exported = flash["loaded"](x)
            diff = (got - want).abs()
            p_diff = (torch.from_numpy(exported["probabilities"]) - want_probs).abs()
            out[label] = {
                "encode_max_abs_err": float(diff.max()),
                "encode_in_tol": bool((diff <= 1e-5 + 1e-4 * want.abs()).all()),
                "export_prob_max_abs_err": float(p_diff.max()),
                "export_in_tol": bool((p_diff <= 1e-5 + 1e-4 * want_probs.abs()).all()),
                "export_tokens_equal": bool(np.array_equal(exported["tokens"],
                                                           want_tokens.numpy())),
                "conv1d_max_abs_err": float((conv.double() - conv_want).abs().max()),
            }
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = run_flags
    d = out["default"]
    print("TF32 check (cuDNN defaults: cudnn.allow_tf32=True, matmul.allow_tf32=False): f32 "
          f"conformer encode B=256 T'={T_STEPS} card vs CPU max abs err "
          f"{d['encode_max_abs_err']:.3e} (TF32 off {out['tf32_off']['encode_max_abs_err']:.3e}); "
          f"exported f32 'flash' program B=256 probabilities vs CPU {d['export_prob_max_abs_err']:.3e}"
          f" (TF32 off {out['tf32_off']['export_prob_max_abs_err']:.3e}), tokens equal "
          f"{d['export_tokens_equal']}; a bare f32 depthwise conv1d (D={D}, K={K}) vs float64 "
          f"{d['conv1d_max_abs_err']:.3e} (TF32 off {out['tf32_off']['conv1d_max_abs_err']:.3e})"
          f"  [{gpu_line()}]")
    for label, r in out.items():
        check(r["encode_in_tol"], f"TF32 check ({label}): the f32 encode is outside the f32 "
                                  f"tolerance of the CPU's ({r['encode_max_abs_err']:.3e})")
        check(r["export_tokens_equal"] and r["export_in_tol"],
              f"TF32 check ({label}): the exported program differs from the CPU predictor "
              f"({r['export_prob_max_abs_err']:.3e})")
    return out


def trainer_tools_phase(root: str) -> tuple:
    """Phase 21's trainer paths on one two-subject experiment, in order;
    returns their results, the trained trainer and the manifest (phase 29
    goes on with both)."""
    t0 = time.perf_counter()
    manifest = transfer_experiment(root)
    logdir = f"{root}/xfer/tb"
    trainer = transfer_trainer(manifest, tf_summaries_dir=logdir)
    trainer.write_tf_records_maybe()
    setup_s = time.perf_counter() - t0
    print(f"phase 21 set-up: demo experiment of 2 subjects at the benchmark's widths, records "
          f"written in {setup_s:.2f} s")
    out = {"setup_s": setup_s}
    out["curriculum"] = curriculum_phase(trainer, logdir)
    out["rollback"] = rollback_phase(trainer)
    out["recovery"] = recovery_phase(manifest, trainer)
    out["tf1"] = tf1_phase(manifest, trainer, out["recovery"]["want"])
    out["analysis"] = analysis_phase(trainer)
    out["lazy"] = lazy_shard_phase(manifest)
    return out, trainer, manifest


# --------------------------------------------------------------------------
# 29. the experiment sweeps and the electrode contributions: main paths
# --------------------------------------------------------------------------

# the sweeps' epochs a cell, folds and fractions of the target's trials
SWEEP_EPOCHS = 2
SWEEP_FOLDS, SWEEP_FRACTIONS = 2, (0.5, 1.0)
# the grid: both encoder families, two learning rates; the conformer at the
# headline widths of phases 7 and 8 under 'flash' (the biLSTM cells ignore it)
SWEEP_GRID = {"encoder_type": ["lstm", "conformer"], "learning_rate": [1e-3, 5e-4]}
OCCLUSION = dict(mask_extent=(2, 2), stride=2)


class _CellClock:
    """Wall time of each trainer a sweep builds (a cell): its set-up (the
    constructor, packing the records, the upload; outermost calls only),
    ``fit`` and ``assess``, each ending in a synchronise.  Wraps the
    trainer's methods while the ``with`` lasts."""

    SETUP = ("__init__", "packed_dataset", "device_data")

    def __enter__(self):
        self.cells: list = []
        self._saved = {m: getattr(MultiSubjectTrainer, m)
                       for m in (*self.SETUP, "fit", "assess")}
        for name, fn in self._saved.items():
            setattr(MultiSubjectTrainer, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(MultiSubjectTrainer, name, fn)

    def _wrap(self, name, fn):
        setup = name in self.SETUP

        def clocked(trainer, *args, **kw):
            outer = not trainer.__dict__.get("_clock_depth", 0)
            trainer.__dict__["_clock_depth"] = trainer.__dict__.get("_clock_depth", 0) + 1
            t0 = time.perf_counter()
            try:
                return fn(trainer, *args, **kw)
            finally:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                trainer.__dict__["_clock_depth"] -= 1
                if name == "__init__":
                    trainer.__dict__["_clock_cell"] = len(self.cells)
                    self.cells.append({"start": t0, "setup_s": 0.0, "fit_s": 0.0,
                                       "assess_s": 0.0})
                cell = (self.cells[trainer.__dict__["_clock_cell"]]
                        if "_clock_cell" in trainer.__dict__ else None)
                if cell is not None:
                    if setup and outer:
                        cell["setup_s"] += t1 - t0
                    elif not setup:
                        cell[f"{name}_s"] += t1 - t0
                    cell["end"] = t1

        return clocked

    def summary(self) -> list:
        return [{"s": c["end"] - c["start"], "setup_s": c["setup_s"], "fit_s": c["fit_s"],
                 "assess_s": c["assess_s"]} for c in self.cells]


def _sweep_steps(counts, batch_size: int, epochs: int) -> int:
    return epochs * sum(-(-int(n) // batch_size) for n in counts if n)


def _describe_cells(cells: list) -> str:
    first, rest = cells[0], cells[1:]
    mean = lambda key: float(np.mean([c[key] for c in rest])) if rest else 0.0  # noqa: E731
    return (f"first cell {first['s']:.2f} s (set-up {first['setup_s']:.2f} s, fit "
            f"{first['fit_s']:.2f} s, assess {first['assess_s']:.2f} s); the other "
            f"{len(rest)} cells {mean('s'):.2f} s a cell (set-up {mean('setup_s'):.2f} s, fit "
            f"{mean('fit_s'):.2f} s, assess {mean('assess_s'):.2f} s)")


def perf_sweep_phase(manifest: str) -> dict:
    """``experiments.perf_vs_training_size`` under ``use_pallas_lstm='bi_grid'``:
    every cell a fresh full-width trainer on the target's subset (the donor
    whole), K4f 3 a training step and 3 an assessment encode, K4b 3 a step,
    nothing else, all on the cluster bodies; the archive loads through ``DecodingResults`` with shape
    (folds, fractions), finite WERs and more seconds for more trials."""
    base = transfer_trainer(manifest, tf_summaries_dir=None, checkpoint_every_assessment=False,
                            use_pallas_lstm="bi_grid")
    counts = base.packed_dataset("training").num_trials
    n_target = int(counts[-1])
    steps = sum(_sweep_steps([*counts[:-1], max(int(round(f * n_target)), 1)],
                             base.batch_size, SWEEP_EPOCHS) for f in SWEEP_FRACTIONS)
    steps *= SWEEP_FOLDS
    encodes = _encodes(base, ["validation"]) * SWEEP_FOLDS * len(SWEEP_FRACTIONS)
    layers = len(base.net_config.rnn_sizes)
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    with _CellClock() as clock:
        t0 = time.perf_counter()
        path = experiments.perf_vs_training_size(
            base, num_folds=SWEEP_FOLDS, fractions=SWEEP_FRACTIONS, num_epochs=SWEEP_EPOCHS,
            suffix="bi_grid")
        sweep_s = time.perf_counter() - t0
    counts_k = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    check_counts("perf_vs_training_size (bi_grid)", counts_k,
                 {"K4f": layers * (steps + encodes), "K4b": layers * steps})
    for kernel in ("K4f", "K4b"):
        check_bodies("perf_vs_training_size (bf16)", bodies, kernel, "cluster", counts_k[kernel])
    res = DecodingResults("", "", path=path)
    wer = np.asarray(res.word_error_rate)
    check(wer.shape == (SWEEP_FOLDS, len(SWEEP_FRACTIONS)) and np.isfinite(wer).all()
          and np.isfinite(np.asarray(res.accuracy)).all(),
          f"perf_vs_training_size: WER {wer}")
    secs = np.asarray(res.nums_seconds)
    check(bool((np.diff(secs, axis=1) > 0).all()), f"perf_vs_training_size: seconds {secs}")
    cells = clock.summary()
    check(len(cells) == SWEEP_FOLDS * len(SWEEP_FRACTIONS), f"perf sweep: {len(cells)} cells")
    print(f"perf_vs_training_size ('bi_grid', {SWEEP_FOLDS} folds x fractions "
          f"{SWEEP_FRACTIONS} of {n_target} target trials, {SWEEP_EPOCHS} epochs a cell, "
          f"B={base.batch_size}, bf16): {sweep_s:.2f} s, {steps} steps, {encodes} assessment "
          f"encodes; {_describe_cells(cells)}; launches {counts_k}; WER by fold x size "
          f"{wer.tolist()}, seconds {secs.tolist()}  [{gpu_line()}]")
    return {"counts": counts_k, "s": sweep_s, "cells": cells, "steps": steps,
            "encodes": encodes, "wers": wer.tolist()}


def grid_sweep_phase(manifest: str) -> dict:
    """``experiments.grid_search`` over both encoder families and two
    learning rates: the biLSTM cells (True) launch K1f and K1b 6 a step
    (K1f 6 an assessment encode too) on the cluster bodies, the conformer
    cells ('flash', the headline widths) K2f / K2b-dq / K2b-dkv once a
    block and K5f / K5b 5 times a block in every step (K2f and K5f in every
    encode too), K2 on the tensor cores, K5b on its registers body;
    the archive loads through ``GridSearchResults`` and ``best()`` names a
    cell."""
    conformer = {**HEADLINE_CONFORMER, "attention_impl": "flash"}
    base = transfer_trainer(manifest, tf_summaries_dir=None, checkpoint_every_assessment=False,
                            conformer=conformer)
    counts = base.packed_dataset("training").num_trials
    cells_a_family = len(SWEEP_GRID["learning_rate"])
    steps = cells_a_family * _sweep_steps(counts, base.batch_size, SWEEP_EPOCHS)
    encodes = cells_a_family * _encodes(base, ["validation"])
    nb, ln = conformer["num_blocks"], conformer["num_blocks"] * LN_PER_BLOCK["flash"]
    lstm = 2 * len(base.net_config.rnn_sizes)
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    with _CellClock() as clock:
        t0 = time.perf_counter()
        path = experiments.grid_search(base, SWEEP_GRID, num_epochs=SWEEP_EPOCHS, suffix="families")
        sweep_s = time.perf_counter() - t0
    counts_k = read_counts()
    bodies = read_bodies()
    # ------------------------------------------------------------------
    check_counts("grid_search", counts_k, {
        "K1f": lstm * (steps + encodes), "K1b": lstm * steps,
        "K2f": nb * (steps + encodes), "K2b-dq": nb * steps, "K2b-dkv": nb * steps,
        "K5f": ln * (steps + encodes), "K5b": ln * steps})
    for kernel in ("K2f", "K2b-dq", "K2b-dkv"):
        check_bodies("grid_search conformer cells (bf16)", bodies, kernel, "tensor_core",
                     counts_k[kernel])
    check_bodies("grid_search conformer cells (bf16)", bodies, "K5b", "registers",
                 counts_k["K5b"])
    for kernel in ("K1f", "K1b"):
        check_bodies("grid_search biLSTM cells (bf16)", bodies, kernel, "cluster",
                     counts_k[kernel])
    gs = GridSearchResults(path)
    check(gs.wers.shape == tuple(len(v) for v in SWEEP_GRID.values())
          and np.isfinite(gs.wers).all(), f"grid_search: WERs {gs.wers}")
    best = gs.best()
    check(str(best["encoder_type"]) in SWEEP_GRID["encoder_type"]
          and float(best["learning_rate"]) in SWEEP_GRID["learning_rate"],
          f"grid_search: best {best}")
    cells = clock.summary()
    check(len(cells) == gs.wers.size, f"grid sweep: {len(cells)} cells")
    print(f"grid_search ({SWEEP_GRID}, conformer {conformer}, {SWEEP_EPOCHS} epochs a cell, "
          f"B={base.batch_size}, bf16): {sweep_s:.2f} s, {steps} steps and {encodes} "
          f"assessment encodes a family; {_describe_cells(cells)}; launches {counts_k}; "
          f"WERs {gs.wers.tolist()}, best {best}  [{gpu_line()}]")
    return {"counts": counts_k, "s": sweep_s, "cells": cells, "steps": steps,
            "encodes": encodes, "wers": gs.wers.tolist(),
            "best": {k: (v if isinstance(v, float) else str(v)) for k, v in best.items()}}


def contributions_phase(trainer: MultiSubjectTrainer) -> dict:
    """``ResultsPlotter(target, trainer).elec_contribs`` on phase 21's
    trained biLSTM (bf16, True): weight norms (no kernel), saliency (6 K1f
    + 6 K1b a subject), occlusion of the validation trials (6 K1f a mask
    position's decode and an assessment encode), all on the cluster
    bodies; in f32 the kernel path
    against the plain path: the occlusion WERs equal, the saliency
    contributions within the f32 tolerance normwise."""
    plotter = ResultsPlotter(trainer.target_subject, trainer, VERBOSE=False)
    S = len(trainer.ecog_subjects)
    out: dict = {}
    for method, kw in (("weight_norms", {}), ("saliency_map", {}),
                       ("occlusion_tested", OCCLUSION)):
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        contribs = plotter.elec_contribs(method, **kw)
        torch.cuda.synchronize()
        out[method] = {"s": time.perf_counter() - t0, "counts": read_counts(),
                       "bodies": read_bodies()}
        # ------------------------------------------------------------------
        for kernel in ("K1f", "K1b"):
            check_bodies(f"{method} (bf16)", out[method]["bodies"], kernel, "cluster",
                         out[method]["counts"][kernel])
        check(contribs.shape == (plotter.grid.num_channels,) and np.isfinite(contribs).all(),
              f"{method}: contributions {contribs.shape}")
        out[method]["contribs"] = contribs
    rows, cols = plotter.grid.layout.shape
    (er, ec), stride = OCCLUSION["mask_extent"], OCCLUSION["stride"]
    positions = len(range(0, rows - er + 1, stride)) * len(range(0, cols - ec + 1, stride))
    check_counts("weight norms", out["weight_norms"]["counts"], {})
    check_counts("saliency contributions", out["saliency_map"]["counts"],
                 {"K1f": 6 * S, "K1b": 6 * S})
    check_counts("occlusion contributions", out["occlusion_tested"]["counts"],
                 {"K1f": 6 * (positions + _encodes(trainer, ["validation"]))})
    check(out["saliency_map"]["contribs"].max() > 0, "saliency: all zero")
    # f32: the kernel path against the plain path
    cfg = trainer.net_config
    f32 = {}
    try:
        for name, pallas in (("kernel", True), ("plain", False)):
            trainer.net_config = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                                     use_pallas_lstm=pallas)
            trainer._device_data.clear()  # inputs uploaded in f32
            f32[name] = (plotter.elec_contribs("saliency_map"),
                         plotter._occlusion_wers("validation", **OCCLUSION)[0])
    finally:
        trainer.net_config = cfg
        trainer._device_data.clear()
    sal_err, _ = compare("saliency contributions f32 kernel vs plain",
                         torch.from_numpy(f32["kernel"][0]), torch.from_numpy(f32["plain"][0]),
                         TOL[torch.float32], normwise=True)
    check(np.array_equal(f32["kernel"][1], f32["plain"][1]),
          f"occlusion WERs f32: kernel {f32['kernel'][1]} vs plain {f32['plain'][1]}")
    occl = out["occlusion_tested"]
    print(f"electrode contributions of the target ({plotter.grid.num_channels} channels, "
          f"bf16): weight norms {out['weight_norms']['s']:.3f} s; saliency "
          f"{out['saliency_map']['s']:.2f} s, launches {out['saliency_map']['counts']}; "
          f"occlusion ({positions} mask positions {OCCLUSION}) {occl['s']:.2f} s, launches "
          f"{occl['counts']}; f32 kernel vs plain: occlusion WERs equal at all {positions} "
          f"positions, saliency max abs err {sal_err:.3e} (normwise)  [{gpu_line()}]")
    return {"counts": {m: r["counts"] for m, r in out.items()},
            "s": {m: r["s"] for m, r in out.items()}, "positions": positions,
            "sal_err": sal_err}


def sweeps_phase(trainer: MultiSubjectTrainer, manifest: str) -> dict:
    """Phase 29 on phase 21's experiment and trained trainer."""
    t0 = time.perf_counter()
    out = {"perf": perf_sweep_phase(manifest), "grid": grid_sweep_phase(manifest),
           "contributions": contributions_phase(trainer)}
    out["s"] = time.perf_counter() - t0
    print(f"phase 29 (sweeps and contributions): {out['s']:.2f} s  [{gpu_line()}]")
    return out


# --------------------------------------------------------------------------
# 22-25. data, sequence and expert parallelism over torch.distributed, the
# demo twin and the decode-quality orderings: main paths
# --------------------------------------------------------------------------

DIST_STEPS = 3  # timed steps after one warm-up step, on every rank
RANK_TIMEOUT = 600.0  # seconds a spawn may take: a failed or hung rank fails the run
SP_F32_T = 2048  # the sp f32 checks' steps
# normwise over every leaf: summed gradients against one process's at the
# bf16 rtol (phases 22-24); under dp also the parameters' change over the 1 + DIST_STEPS
# Adam steps, where bf16 noise in small gradients flips some elements'
# updates, at a bound that a zero or reversed gradient (error >= 1) fails
GRAD_REL_TOL = TOL[torch.bfloat16]["rtol"]
DP_DELTA_TOL = 0.5
# ep×sp needs dispatch groups that divide the shard (1024 steps) and the
# headline halo (128 steps): groups of 128 steps, in the one-process
# reference too
EP_SP_GROUP = 128
# the ranks' per-step kernel launches: the headline conformer under 'flash'
# and the biLSTM under True
CONFORMER_STEP = {"K2f": 4, "K2b-dq": 4, "K2b-dkv": 4, "K5f": 20, "K5b": 20}
BILSTM_STEP = {"K1f": LAUNCHES_PER_ENCODE, "K1b": LAUNCHES_PER_ENCODE}


def _digest(tree) -> str:
    import hashlib

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _no_dropout(config: Seq2SeqConfig) -> Seq2SeqConfig:
    return dataclasses.replace(config, FF_dropout=0.0, RNN_dropout=0.0)


def _dp_config(which: str) -> Seq2SeqConfig:
    return _no_dropout(conformer_config() if which == "conformer" else serving_config())


def _ep_config(n_seq: int) -> Seq2SeqConfig:
    group = EP_SP_GROUP if n_seq > 1 else MOE_TRAIN["moe_group_size"]
    return _no_dropout(moe_config(moe_capacity_factor=MOE_TRAIN["moe_capacity_factor"],
                                  moe_group_size=group))


def _summed_gradients(step_fn):
    """``step_fn()`` with a spy on the training step's clip
    (``parallel.mesh.make_dp_train_step`` calls
    ``mesh.clip_by_global_norm``): returns its result and f32 copies of the
    gradients the step handed to the clip, summed over the ranks and not
    yet clipped."""
    seen, clip = [], mesh_module.clip_by_global_norm

    def spy(grads, *args, **kw):
        seen.append([g.detach().float().clone() for g in grads])
        return clip(grads, *args, **kw)

    mesh_module.clip_by_global_norm = spy
    try:
        out = step_fn()
    finally:
        mesh_module.clip_by_global_norm = clip
    check(len(seen) == 1, f"the step clipped {len(seen)} times")
    return out, seen[0]


def _rel_norm_err(got: list, want: list) -> float:
    """|got − want| / |want| over every leaf at once (f32 sums)."""
    num = sum(float(torch.sum((g.float().cuda() - w.float().cuda()) ** 2))
              for g, w in zip(got, want))
    den = sum(float(torch.sum(w.float().cuda() ** 2)) for w in want)
    return (num / den) ** 0.5


def _runner_steps(config: Seq2SeqConfig, mesh, steps: int = DIST_STEPS) -> dict:
    """One warm-up step and ``steps`` timed steps of the segment runner on
    global batches of B_TRAIN drawn from the seeded corpus (the same on
    every rank and in one process; on a mesh each rank takes its slice).
    The warm-up step's summed gradients (before the clip) are kept, and the
    parameters' change over all the steps.  Counts are reset after the
    warm-up and read after the last step."""
    p = init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")
    p0 = [t.detach().clone() for t in tree_leaves(p)]
    data = _random_corpus(config)
    state = TrainState(p, tree_map(lambda t: t.detach().clone(), p), make_optimizer(p, 1e-3), 0)
    runner = make_segment_runner(config, PENALTIES, 0.99, mesh)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    subject = np.zeros((1,), np.int32)

    def step() -> float:
        nonlocal state
        idx = rng.permutation(N_TRIALS)[:B_TRAIN][None]
        state, metrics = runner(state, data, subject, idx, gen, 0)
        return float(metrics["loss_total"])

    first_loss, grads = _summed_gradients(step)
    losses = [first_loss]
    timer = StepTimer("cuda")
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    timer.start()
    for _ in range(steps):
        losses.append(step())
        timer.lap(B_TRAIN)
    counts, bodies = read_counts(), read_bodies()
    # ------------------------------------------------------------------
    delta = [t.detach() - t0 for t, t0 in zip(tree_leaves(state.params), p0)]
    return {"state": state, "losses": losses, "step_ms": [1e3 * d for d, _ in timer.laps],
            "counts": counts, "bodies": bodies, "grads": grads, "delta": delta}


def _rank_dp(out_dir: str, which: str) -> dict:
    mesh = make_mesh(n_data=dist.get_world_size())
    r = _runner_steps(_dp_config(which), mesh)
    if mesh.rank == 0:
        torch.save({k: [t.cpu() for t in r[k]] for k in ("grads", "delta")} | {
            "params": tree_map(lambda t: t.detach().cpu(), r["state"].params)},
            os.path.join(out_dir, f"dp_{which}.pt"))
    return {k: r[k] for k in ("losses", "step_ms", "counts", "bodies")} | {
        "digest": _digest(r["state"].params)}


def _long_inputs(T: int, dtype):
    enc = init_conformer(torch.Generator().manual_seed(0), ConformerConfig(**HEADLINE_CONFORMER),
                         LONG_IN, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((LONG_B, LONG_T, LONG_IN), generator=gen, device="cuda")[:, :T].to(dtype)
    w = torch.randn((LONG_B, T, HEADLINE_CONFORMER["model_dim"]),
                    generator=torch.Generator(device="cuda").manual_seed(12), device="cuda")
    return enc, x, torch.full((LONG_B,), T, dtype=torch.int32, device="cuda"), w


def _long_grads(enc, out_fn, w, scale: float = 1.0):
    """Gradients of ``scale · Σ out·w`` over the encoder's leaves."""
    leaves = tree_leaves(enc)
    for t in leaves:
        t.requires_grad_(True)
    out = out_fn()
    grads = torch.autograd.grad(scale * (out.float() * w).sum(), leaves)
    for t in leaves:
        t.requires_grad_(False)
    return list(grads)


def _rank_sp(out_dir: str) -> dict:
    """The long recording over the seq ranks: the encode under 'flash' and
    'fused' (bf16), the f32 encode at SP_F32_T steps, and one training
    step's gradients (bf16 at T'=8192 and f32 at SP_F32_T) of ``Σ out·w``
    with each rank's share 1/n of it and the gradients summed over the
    ranks."""
    n = dist.get_world_size()
    mesh = make_mesh(n_data=1, n_model=1, n_seq=n)
    res = {"counts": {}, "ms": {}}
    save = (lambda obj, name: torch.save(obj, os.path.join(out_dir, name))) \
        if mesh.rank == 0 else (lambda obj, name: None)
    for dtype, T in ((torch.bfloat16, LONG_T), (torch.float32, SP_F32_T)):
        enc, x, lengths, w = _long_inputs(T, dtype)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for impl in (("flash", "fused") if dtype == torch.bfloat16 else ("flash",)):
            ccfg = ConformerConfig(**HEADLINE_CONFORMER, attention_impl=impl)

            def encode_sp():
                with torch.inference_mode():
                    return sequence_parallel_encode(enc, ccfg, x, mesh, "seq", lengths, dtype)

            encode_sp()
            torch.cuda.synchronize()
            timer = StepTimer("cuda")
            # ---- the main path: counts reset just before, read just after ----
            reset_counts()
            timer.start()
            out = encode_sp()
            timer.lap(LONG_B * T)
            res["counts"][f"encode_{impl}_{tag}"] = read_counts()
            # --------------------------------------------------------------
            res["ms"][f"encode_{impl}_{tag}"] = 1e3 * timer.laps[0][0]
            save(out.cpu(), f"sp_encode_{impl}_{tag}.pt")
            del out
        ccfg = ConformerConfig(**HEADLINE_CONFORMER, attention_impl="flash")

        def out_sp():
            return sequence_parallel_encode(enc, ccfg, x, mesh, "seq", lengths, dtype)

        _long_grads(enc, out_sp, w, 1.0 / n)
        timer = StepTimer("cuda")
        reset_counts()
        timer.start()
        grads = _long_grads(enc, out_sp, w, 1.0 / n)
        reduce_gradients_(grads, mesh)
        timer.lap(LONG_B * T)
        res["counts"][f"train_{tag}"] = read_counts()
        res["ms"][f"train_{tag}"] = 1e3 * timer.laps[0][0]
        save([g.cpu() for g in grads], f"sp_grads_{tag}.pt")
        res[f"grads_digest_{tag}"] = _digest(grads)
        del enc, x, w, grads
        torch.cuda.empty_cache()
    return res


def _moe_batch(config: Seq2SeqConfig) -> dict:
    """The MoE cell's batch: B=16 full-length trials of the seeded corpus."""
    t_raw = MOE_T * config.decimation_factor
    data = _random_corpus(config, MOE_TRIALS, t_raw)
    data["encoder_lengths"].fill_(t_raw)
    idx = torch.as_tensor(np.random.default_rng(0).permutation(MOE_TRIALS)[:MOE_B], device="cuda")
    batch = {k: v[0][idx] for k, v in data.items()}
    batch["subject_idx"] = 0
    return batch


def _moe_grads(config, params, batch, **parallel):
    """The loss (dropout off) and its gradients over ``params``' leaves,
    summed over the mesh's ranks when ``parallel`` names one."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    loss, metrics = seq2seq_loss(params, config, batch, None, train=False,
                                 penalty_scales=PENALTIES, **parallel)
    loss.backward()
    grads = [t.grad for t in leaves]
    ep = parallel.get("ep")
    if ep is not None:
        mesh = ep[0]
        local = config.conformer.moe_experts // mesh.shape["model"]
        reduce_gradients_(grads, mesh, tree_leaves(expert_mask(params, local)))
    return float(metrics["loss_total"].detach()), float(metrics["moe_aux"].detach()), grads


def _rank_ep(out_dir: str, n_seq: int) -> dict:
    """The MoE cell over ``world / n_seq`` expert ranks (× ``n_seq`` time
    shards): the loss, the aux loss and every gradient (experts gathered),
    then a checkpoint of the gathered trees written by rank 0."""
    n_model = dist.get_world_size() // n_seq
    mesh = make_mesh(n_data=1, n_model=n_model, n_seq=n_seq)
    config = _ep_config(n_seq)
    E = config.conformer.moe_experts
    params = shard_params_ep(init_seq2seq(config, torch.Generator().manual_seed(0), "cuda"),
                             mesh, E)
    batch = _moe_batch(config)
    parallel = parallel_modes(mesh, "ep")
    _moe_grads(config, params, batch, **parallel)
    timer = StepTimer("cuda")
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    timer.start()
    loss, aux, grads = _moe_grads(config, params, batch, **parallel)
    timer.lap(MOE_B * MOE_T)
    counts = read_counts()
    # ------------------------------------------------------------------
    tree = tree_map(lambda t: t.grad, params)
    full_grads = gather_params_ep(tree, mesh, E)
    full = gather_params_ep(tree_map(lambda t: t.detach(), params), mesh, E)
    tag = f"ep{n_model}_sp{n_seq}"
    if mesh.rank == 0:
        torch.save([g.cpu() for g in tree_leaves(full_grads)],
                   os.path.join(out_dir, f"{tag}_grads.pt"))
        save_checkpoint(os.path.join(out_dir, f"{tag}_ckpt.pt"), full, full, 1)
    dist.barrier()
    return {"loss": loss, "moe_aux": aux, "ms": 1e3 * timer.laps[0][0], "counts": counts,
            "local_experts": int(params["encoder"]["conformer"]["blocks"][0]["ffn2"]["w1"]
                                 .shape[0]),
            "digest": _digest(full)}


def parallel_rank(out_dir: str, phases: list) -> dict:
    """One rank of phases 22-24 and 26-28 (``parallel.launch.spawn`` runs it
    on every rank after ``initialize_distributed``): the named phases in
    order (``tp_pp:<case>`` a case of ``TP_PP_CASES``, read against the
    one-process runs ``tp_pp_references`` saved beside ``out_dir``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for phase in phases:
        if phase in ("dp_conformer", "dp_bilstm"):
            out[phase] = _rank_dp(out_dir, phase[3:])
        elif phase == "sp":
            out[phase] = _rank_sp(out_dir)
        elif phase in ("ep", "ep_sp"):
            out[phase] = _rank_ep(out_dir, 2 if phase == "ep_sp" else 1)
        elif phase.startswith("tp_pp:"):
            name = phase.split(":", 1)[1]
            spec = next(c[name] for c in TP_PP_CASES.values() if name in c)
            out[phase] = _rank_tp_pp(os.path.dirname(out_dir), name, spec)
        torch.cuda.empty_cache()
    out["backend"] = dist.get_backend()
    return out


def _spawn(world: int, phases: list, root: str, backend: str) -> tuple[list, str]:
    out_dir = tempfile.mkdtemp(dir=root)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:parallel_rank", world, {"out_dir": out_dir, "phases": phases},
                  timeout=RANK_TIMEOUT, backend=backend, device="cuda",
                  pythonpath=[os.path.dirname(os.path.abspath(__file__))])
    print(f"spawn of {world} {backend} rank(s) for {phases}: {time.perf_counter() - t0:.1f} s")
    for r in ranks:
        check(r["backend"] == backend, f"a rank ran {r['backend']}, not {backend}")
    return ranks, out_dir


def _check_rank_counts(path: str, ranks: list, get, per_step: dict, steps: int) -> None:
    for i, r in enumerate(ranks):
        check_counts(f"{path}, rank {i}", get(r), {k: v * steps for k, v in per_step.items()})


def _nccl_world_of_one(root: str) -> tuple[list, str]:
    """The data-parallel conformer on a world of one NCCL rank, in this
    process (the card takes one NCCL rank)."""
    out_dir = tempfile.mkdtemp(dir=root)
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                           timeout=RANK_TIMEOUT)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        return [{"dp_conformer": _rank_dp(out_dir, "conformer")}], out_dir
    finally:
        dist.destroy_process_group()


def dp_phase(runs: list) -> dict:
    """22. Data parallelism: the headline conformer ('flash') and the biLSTM
    benchmark model (True), bf16, dropout off, global B=256 over the ranks
    of each run ``(label, ranks, out_dir)`` (2 gloo ranks sharing the card;
    one NCCL rank), against the one-process run on the same global
    batches: the first step's gradients summed over the ranks before the
    clip (normwise, GRAD_REL_TOL) and the parameters' change after
    1 + DIST_STEPS steps (normwise, DP_DELTA_TOL); the ranks' parameters
    bit-identical; the parameters and losses within the bf16 tolerance;
    per rank per step the path's kernels; step times by CUDA events and
    the conformer step's MFU."""
    results = {}
    flops = train_step_flops(_dp_config("conformer"), T_RAW)
    for which, per_step in (("conformer", CONFORMER_STEP), ("bilstm", BILSTM_STEP)):
        key = f"dp_{which}"
        ref = _runner_steps(_dp_config(which), None)
        ref_params = tree_leaves(ref["state"].params)
        ref_norm = sum(float(torch.sum(g ** 2)) for g in ref["grads"]) ** 0.5
        ref_ms = float(np.mean(ref["step_ms"]))
        results[f"{which}_one_process_ms"] = ref_ms
        for label, ranks, out_dir in runs:
            if key not in ranks[0]:
                continue
            rr = [r[key] for r in ranks]
            _check_rank_counts(f"dp {which} ({label})", rr, lambda r: r["counts"], per_step,
                               DIST_STEPS)
            body = "tensor_core" if which == "conformer" else "cluster"
            for k in per_step:
                if k in BODIES and k != "K5b":
                    for i, r in enumerate(rr):
                        check_bodies(f"dp {which} ({label}) rank {i}", r["bodies"], k, body,
                                     r["counts"][k])
            check(len({r["digest"] for r in rr}) == 1,
                  f"dp {which} ({label}): the ranks' parameters differ")
            got = torch.load(os.path.join(out_dir, f"{key}.pt"))
            # what the step computes: the warm-up step's gradients summed
            # over the ranks, before the clip, against one process's (a
            # dropped all-reduce leaves a rank its own share, about half of
            # the sum; a doubled one twice it: errors near 0.5 and 1)
            gerr = _rel_norm_err(got["grads"], ref["grads"])
            gnorm = sum(float(torch.sum(g ** 2)) for g in got["grads"]) ** 0.5
            check(gerr <= GRAD_REL_TOL, f"dp {which} ({label}): summed gradients off by "
                                       f"{gerr:.3e} of their norm (limit {GRAD_REL_TOL})")
            # and where the steps took the parameters
            derr = _rel_norm_err(got["delta"], ref["delta"])
            check(derr <= DP_DELTA_TOL, f"dp {which} ({label}): parameter change off by "
                                        f"{derr:.3e} of its norm (limit {DP_DELTA_TOL})")
            err = max(compare(f"dp {which} ({label}) params", g.cuda(), w.detach(),
                              TOL[torch.bfloat16])[0]
                      for g, w in zip(tree_leaves(got["params"]), ref_params))
            lerr = compare(f"dp {which} ({label}) losses", torch.tensor(rr[0]["losses"]),
                           torch.tensor(ref["losses"]), TOL[torch.bfloat16])[0]
            ms = float(np.mean([np.mean(r["step_ms"]) for r in rr]))
            results[f"{which}_{label}"] = {
                "counts_by_rank": [r["counts"] for r in rr],
                "step_ms_by_rank": [r["step_ms"] for r in rr], "ms": ms, "param_err": err,
                "grad_rel_err": gerr, "delta_rel_err": derr, "grad_norm": gnorm,
                "one_process_grad_norm": ref_norm, "loss_err": lerr, "losses": rr[0]["losses"]}
            mfu_note = ""
            if which == "conformer":
                results[f"{which}_{label}"]["mfu"] = mfu(B_TRAIN / (ms / 1e3), flops)
                mfu_note = (f"; MFU {results[f'{which}_{label}']['mfu']:.4f} (one process "
                            f"{mfu(B_TRAIN / (ref_ms / 1e3), flops):.4f}; {flops:.4e} model "
                            f"FLOPs a sentence, dense bf16 peak {H100_BF16_PEAK_FLOPS:.3e})")
            print(f"dp {which} ({label}), global B={B_TRAIN}, bf16: losses "
                  + ", ".join(f"{x:.4f}" for x in rr[0]["losses"])
                  + " (one process " + ", ".join(f"{x:.4f}" for x in ref["losses"])
                  + f"); first step's summed gradients (norm {gnorm:.4e}, one process "
                  f"{ref_norm:.4e}) off by {gerr:.3e} of their norm, parameter change by "
                  f"{derr:.3e}; parameters max abs err {err:.3e}; ranks bit-identical; "
                  f"step {ms:.2f} ms (one process {ref_ms:.2f} ms){mfu_note}; per rank per "
                  f"step {per_step}  [{gpu_line()}]")
        del ref, ref_params
        torch.cuda.empty_cache()
    results["conformer_one_process_mfu"] = mfu(
        B_TRAIN / (results["conformer_one_process_ms"] / 1e3), flops)
    return results


def _long_reference(dtype, T: int, impl: str, grads: bool):
    enc, x, lengths, w = _long_inputs(T, dtype)
    ccfg = ConformerConfig(**HEADLINE_CONFORMER, attention_impl=impl)

    def out_fn():
        out, _ = conformer_encode(enc, ccfg, x, lengths, compute_dtype=dtype)
        return out

    if grads:
        _long_grads(enc, out_fn, w)
        timer = StepTimer("cuda")
        timer.start()
        g = _long_grads(enc, out_fn, w)
        timer.lap()
        return g, 1e3 * timer.laps[0][0]
    with torch.inference_mode():
        out_fn()
        timer = StepTimer("cuda")
        timer.start()
        out = out_fn()
        timer.lap()
    return out, 1e3 * timer.laps[0][0]


def sp_phase(ranks: list, out_dir: str) -> dict:
    """23. Sequence parallelism: the long recording (B=16, T'=8192) over 2
    seq ranks (gloo, the card shared): the encode under 'flash' and
    'fused' (bf16) and under 'flash' in f32 at T'=2048 equal the
    one-process encode; one training step's gradients (bf16, and f32 at
    T'=2048) equal the one-process step's (normwise: sums over 131072
    tokens in another order).  Rank 0's window starts at −halo (−128):
    negative offsets through K2f, K3f and K2b on the tensor cores."""
    rr = [r["sp"] for r in ranks]
    nb = HEADLINE_CONFORMER["num_blocks"]
    per = {"encode_flash": {"K2f": nb, "K5f": nb * LN_PER_BLOCK["flash"]},
           "encode_fused": {"K3f": nb, "K5f": nb * LN_PER_BLOCK["fused"]},
           "train": {"K2f": nb, "K2b-dq": nb, "K2b-dkv": nb, "K5f": nb * LN_PER_BLOCK["flash"],
                     "K5b": nb * LN_PER_BLOCK["flash"]}}
    for key in ("encode_flash_bf16", "encode_fused_bf16", "encode_flash_f32", "train_bf16",
                "train_f32"):
        want = per[key.rsplit("_", 1)[0]]
        _check_rank_counts(f"sp {key}", rr, lambda r: r["counts"][key], want, 1)
    check(len({r["grads_digest_bf16"] for r in rr}) == 1,
          "sp: the ranks' summed gradients differ")
    errs, ref_ms = {}, {}
    for dtype, T, tag in ((torch.bfloat16, LONG_T, "bf16"), (torch.float32, SP_F32_T, "f32")):
        for impl in (("flash", "fused") if tag == "bf16" else ("flash",)):
            want, ref_ms[f"encode_{impl}_{tag}"] = _long_reference(dtype, T, impl, False)
            got = torch.load(os.path.join(out_dir, f"sp_encode_{impl}_{tag}.pt")).cuda()
            errs[f"encode_{impl}_{tag}"] = compare(f"sp encode ({impl}, {tag}, T'={T})", got,
                                                   want, TOL[dtype])[0]
            del want, got
        want, ref_ms[f"train_{tag}"] = _long_reference(dtype, T, "flash", True)
        got = torch.load(os.path.join(out_dir, f"sp_grads_{tag}.pt"))
        errs[f"train_{tag}"] = max(
            compare(f"sp gradient leaf {i} ({tag}, T'={T})", g.cuda(), w, TOL[dtype],
                    normwise=True)[0] for i, (g, w) in enumerate(zip(got, want)))
        errs[f"train_{tag}_rel"] = _rel_norm_err(got, want)
        check(errs[f"train_{tag}_rel"] <= TOL[dtype]["rtol"],
              f"sp gradients ({tag}) off by {errs[f'train_{tag}_rel']:.3e} of their norm")
        del want, got
        torch.cuda.empty_cache()
    ms = {k: [r["ms"][k] for r in rr] for k in rr[0]["ms"]}
    print(f"sp ({len(rr)} seq ranks, {ranks[0]['backend']}), B={LONG_B}: max abs err vs one "
          f"process {errs}; "
          f"ms by rank {ms}; one process {ref_ms}  [{gpu_line()}]")
    return {"counts_by_rank": [r["counts"] for r in rr], "errs": errs, "ms_by_rank": ms,
            "one_process_ms": ref_ms}


def ep_phase(runs: list) -> dict:
    """24. Expert parallelism: the MoE cell (8 experts, top 2, capacity
    1.25, B=16 × T'=2048, bf16, 'flash', dropout off) over the expert
    ranks of each run ``(label, ranks, out_dir, n_seq)`` (2 expert ranks,
    groups of 512; 2 × 2 with 2 seq ranks, groups of 128, which divide the
    shard and the halo): the loss, the aux loss and every gradient equal
    the one-process step's; the checkpoint of the gathered trees rank 0
    wrote restores in one process, bit for bit."""
    nb = HEADLINE_CONFORMER["num_blocks"]
    results = {}
    for label, ranks, out_dir, n_seq in runs:
        rr = [r["ep_sp" if n_seq > 1 else "ep"] for r in ranks]
        n_model = len(rr) // n_seq
        _check_rank_counts(f"{label}", rr, lambda r: r["counts"],
                           {"K2f": nb, "K2b-dq": nb, "K2b-dkv": nb,
                            "K5f": nb * LN_PER_BLOCK["flash"], "K5b": nb * LN_PER_BLOCK["flash"]},
                           1)
        check(all(r["local_experts"] == MOE["moe_experts"] // n_model for r in rr),
              f"{label}: local experts {[r['local_experts'] for r in rr]}")
        check(len({r["digest"] for r in rr}) == 1, f"{label}: gathered trees differ by rank")
        config = _ep_config(n_seq)
        params = init_seq2seq(config, torch.Generator().manual_seed(0), "cuda")
        batch = _moe_batch(config)
        _moe_grads(config, params, batch)
        timer = StepTimer("cuda")
        timer.start()
        loss, aux, grads = _moe_grads(config, params, batch)
        timer.lap()
        tag = f"ep{n_model}_sp{n_seq}"
        got = torch.load(os.path.join(out_dir, f"{tag}_grads.pt"))
        gerr = max(compare(f"{label} gradient leaf {i}", g.cuda(), w, TOL[torch.bfloat16],
                           normwise=True)[0] for i, (g, w) in enumerate(zip(got, grads)))
        grel = _rel_norm_err(got, grads)
        check(grel <= GRAD_REL_TOL, f"{label}: gradients off by {grel:.3e} of their norm "
                                    f"(limit {GRAD_REL_TOL})")
        lerr = compare(f"{label} loss", torch.tensor([r["loss"] for r in rr]),
                       torch.tensor([loss] * len(rr)), TOL[torch.bfloat16])[0]
        aerr = compare(f"{label} moe_aux", torch.tensor([r["moe_aux"] for r in rr]),
                       torch.tensor([aux] * len(rr)), TOL[torch.bfloat16])[0]
        ckpt = load_checkpoint(os.path.join(out_dir, f"{tag}_ckpt.pt"), "cuda")
        check(_shape_tree(ckpt["params"]) == _shape_tree(params),
              f"{label}: the checkpoint's shapes are not the one-process tree's")
        check(_digest(ckpt["params"]) == rr[0]["digest"],
              f"{label}: the restored checkpoint differs from the gathered trees")
        ms = [r["ms"] for r in rr]
        results[label] = {"counts_by_rank": [r["counts"] for r in rr], "ms_by_rank": ms,
                          "one_process_ms": 1e3 * timer.laps[0][0], "grad_err": gerr,
                          "grad_rel_err": grel, "loss_err": lerr, "aux_err": aerr,
                          "moe_aux": aux}
        print(f"{label} ({ranks[0]['backend']}; groups of {config.conformer.moe_group_size}): loss "
              f"{rr[0]['loss']:.5f} vs {loss:.5f}, moe_aux {rr[0]['moe_aux']:.6f} vs {aux:.6f}; "
              f"gradients max abs err {gerr:.3e} (normwise), {grel:.3e} of their norm; "
              f"checkpoint restored in one process "
              f"bit for bit; loss+backward ms by rank {[f'{x:.2f}' for x in ms]}, one process "
              f"{1e3 * timer.laps[0][0]:.2f}  [{gpu_line()}]")
        del params, batch, grads, ckpt
        torch.cuda.empty_cache()
    return results


def demo_twin_phase(root: str) -> dict:
    """25a. ``python -m ecog2txt_tpu_torch.run_demo`` (its ``main``) at the
    JAX demo's defaults, on the card with ``--use-pallas-lstm True``: WER 0
    on the validation and testing blocks, K1f and K1b launched, and the
    analysis step's electrode contributions finite, one a channel of the
    4x4 grid."""
    t0 = time.perf_counter()
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    out = run_demo.main([os.path.join(root, "demo_twin"), "--device", "cuda",
                         "--use-pallas-lstm", "True"])
    counts = read_counts()
    # ------------------------------------------------------------------
    s = time.perf_counter() - t0
    wers = {p: out[p]["word_error_rate"] for p in ("validation", "testing")}
    check(counts["K1f"] > 0 and counts["K1b"] > 0, f"demo twin: launches {counts}")
    check(all(v == 0 for k, v in counts.items() if k not in ("K1f", "K1b")),
          f"demo twin: launches {counts}")
    check(wers == {"validation": 0.0, "testing": 0.0}, f"demo twin: WER {wers}")
    contribs = out["elec_contribs"]
    check(contribs.shape == (16,) and bool(np.isfinite(contribs).all()),
          f"demo twin: electrode contributions {contribs}")
    print(f"demo twin (100 epochs, f32, True): WER {wers} in {s:.1f} s; electrode "
          f"contributions (weight norms, 4x4 grid) {contribs.round(3).tolist()}; "
          f"launches {counts}")
    return {"counts": counts, "wers": wers, "s": s,
            "elec_contribs": [float(c) for c in contribs]}


OP_POINT = dict(synth_pattern_correlation=0.35, synth_noise_scale=0.15,
                num_unique_sentences=12, num_sentences_per_block=12, num_training_blocks=3)


def _op_trainer(root: str, subject_ids=(1,)) -> MultiSubjectTrainer:
    mp = make_demo_experiment(root, subject_ids=subject_ids, grid_size=(4, 4),
                              phoneme_sequence_distribution="CTC", **OP_POINT)
    return MultiSubjectTrainer(mp, list(subject_ids), VERBOSE=False, device="cuda",
                               SN_kwargs={"batch_size": 12, "max_dec_len": 10,
                                          "learning_rate": 3e-3, "use_pallas_lstm": True})


def _op_assess(trainer: MultiSubjectTrainer, beam: int = 1, temp: float = 0.0) -> dict:
    trainer.beam_width = beam
    trainer.SN_kwargs["temperature"] = temp
    return trainer.assess(["validation"])["validation"]


def _lexicon_wer(trainer: MultiSubjectTrainer, references: list) -> tuple[float, float]:
    """The CTC head alone, its log-probs rescored through the word lexicon
    (``CTCWordBeamState``, width 8) on the validation trials against the
    assessment's ``references``: (WER, mean phonemes a trial after
    collapsing the greedy path)."""
    from ecog2txt_tpu_torch.models.ctc import CTCWordBeamState, collapse_alignment
    from ecog2txt_tpu_torch.serve import _ctc_head_apply

    manifests = trainer.target_subject.data_manifests
    phonemes = manifests["encoder_1_targets"].feature_list
    ids = {p: i for i, p in enumerate(phonemes)}
    lex = {w: [ids[p] for p in word_to_phonemes(w.rstrip("_"))]
           for w in manifests["decoder_targets"].feature_list
           if not w.startswith("<") and all(p in ids for p in word_to_phonemes(w.rstrip("_")))}
    trie, blank = LexiconTrie(lex), len(phonemes)
    ds = trainer.packed_dataset("validation")
    params, cfg = trainer.state.ema, trainer.net_config
    hyps, n_phon = [], []
    with torch.inference_mode():
        x = torch.from_numpy(ds.encoder_inputs[0]).cuda()
        lengths = torch.from_numpy(ds.encoder_lengths[0]).cuda()
        enc_out, _, enc_lens = encode(params, cfg, x, lengths, 0)
        enc_bm = enc_out.transpose(0, 1)
        for i in range(int(ds.num_trials[0])):
            n = int(enc_lens[i])
            path, logp = _ctc_head_apply(params, cfg, "encoder_1_targets", enc_bm[i:i + 1, :n],
                                         want_logp=True)
            n_phon.append(len([x for x in collapse_alignment(path[:, 0]) if int(x) != blank]))
            state = CTCWordBeamState(trie, beam_width=8)
            state.advance(logp[:, 0])
            hyps.append(" ".join(w.rstrip("_") for w in state.best()))
    return float(np.mean(wer_vector(references, hyps))), float(np.mean(n_phon))


def decode_quality_phase(root: str) -> dict:
    """25b. The orderings ``tests/test_decode_quality.py`` pins at its
    calibrated operating point, on the card (f32, True): greedy in (0,
    0.3], beam 8 no worse, the CTC head's lexicon rescoring usable (WER
    below 0.5, at least 3 phonemes a trial); a donor-pretrained target
    (the sequential curriculum) beats the cold one at the same target
    budget.  The temperature-1 WER is printed beside them (the JAX package
    reports it, one seed, and pins no ordering for it).

    The phase runs under ``torch.use_deterministic_algorithms``: with
    PyTorch's default algorithms two runs of the same training differ in
    the last bits (5.96e-08 after 5 epochs) and the orderings, taken at
    one seed, came out either way (beam worse than greedy once, transfer
    worse than cold once, in four runs on an H100).  Under them two runs
    give the same parameters bit for bit; ``warn_only``, because an op
    without a deterministic version would raise otherwise."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _decode_quality(root)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _decode_quality(root: str) -> dict:
    t0 = time.perf_counter()
    reset_counts()
    cold = _op_trainer(os.path.join(root, "op_cold"))
    cold.fit(num_epochs=160, assess=False)
    greedy = _op_assess(cold)
    wers = {"greedy": greedy["word_error_rate"],
            "beam8": _op_assess(cold, beam=8)["word_error_rate"],
            "temperature1": _op_assess(cold, temp=1.0)["word_error_rate"]}
    wers["lexicon"], phonemes = _lexicon_wer(cold, greedy["references"])
    tl = _op_trainer(os.path.join(root, "op_tl"), subject_ids=(2, 1))
    tl.sequential_transfer_learn(pretraining=40, training=80, posttraining=80)
    wers["transfer"] = _op_assess(tl)["word_error_rate"]
    counts = read_counts()
    s = time.perf_counter() - t0
    check(0.0 < wers["greedy"] <= 0.3, f"decode quality: greedy WER {wers}")
    check(wers["beam8"] <= wers["greedy"], f"decode quality: beam worse than greedy {wers}")
    check(wers["lexicon"] < 0.5 and phonemes >= 3.0,
          f"decode quality: lexicon rescoring {wers}, {phonemes:.2f} phonemes a trial")
    check(wers["transfer"] < wers["greedy"], f"decode quality: transfer not better {wers}")
    check(counts["K1f"] > 0 and counts["K1b"] > 0, f"decode quality: launches {counts}")
    print(f"decode quality at the operating point (f32, True): WER {wers}, {phonemes:.2f} "
          f"phonemes a trial from the CTC head, in {s:.1f} s; launches {counts}")
    return {"counts": counts, "wers": wers, "s": s}


# --------------------------------------------------------------------------
# 26-28. tensor and pipeline parallelism, and their compositions
# --------------------------------------------------------------------------

# world → case → (model, (data, model, seq, pp) ranks, microbatches, what the
# model axis splits): one spawn a world size
TP_PP_CASES = {
    2: {"tp2_bilstm_true": ("bilstm_true", (1, 2, 1, 1), 0, "tp"),
        "tp2_bilstm_grid": ("bilstm_grid", (1, 2, 1, 1), 0, "tp"),
        "tp2_conformer": ("conformer", (1, 2, 1, 1), 0, "tp"),
        "tp2_fused_encode": ("fused_encode", (1, 2, 1, 1), 0, "tp"),
        "pp2": ("conformer", (1, 1, 1, 2), 2, None)},
    4: {"pp4": ("conformer", (1, 1, 1, 4), 4, None),
        "dp2_tp2": ("conformer", (2, 2, 1, 1), 0, "tp"),
        "dp2_pp2": ("conformer", (2, 1, 1, 2), 2, None),
        "tp2_sp2": ("long", (1, 2, 2, 1), 0, "tp"),
        "sp2_pp2": ("long", (1, 1, 2, 2), 2, None),
        "ep2_pp2": ("moe", (1, 2, 1, 2), 2, "ep"),
        "tp2_pp2": ("conformer", (1, 2, 1, 2), 2, "tp")},
    8: {"ep2_sp2_pp2": ("moe_sp", (1, 2, 2, 2), 2, "ep"),
        "tp2_sp2_pp2": ("long", (1, 2, 2, 2), 2, "tp")},
}
TP_PP_LR = 1e-3
LSTM_BODIES = ("K1f", "K1b", "K4f", "K4b")


def _tp_pp_problem(model: str) -> dict:
    """One case's model at full width (bf16, dropout off, seed 0) and its
    two global batches, the same on every rank and in one process: the
    biLSTM benchmark model (True or 'bi_grid') and the headline conformer
    ('flash'; 'fused' for the encode) on B=256 of the seeded corpus, the MoE
    cell (groups of 512, or of 128 where a seq axis cuts it), or the long
    recording's encoder (B=16, T'=8192) under ``Σ out·w``."""
    if model == "long":
        enc, x, lengths, w = _long_inputs(LONG_T, torch.bfloat16)
        batch = {"x": x, "w": w, "lengths": lengths}
        return {"config": ConformerConfig(**HEADLINE_CONFORMER, attention_impl="flash"),
                "params": enc, "batches": [batch, batch], "tokens": LONG_B * LONG_T}
    if model.startswith("moe"):
        config = _ep_config(2 if model == "moe_sp" else 1)
        batch = _moe_batch(config)
        return {"config": config, "params": init_seq2seq(config, torch.Generator()
                                                        .manual_seed(0), "cuda"),
                "batches": [batch, batch], "tokens": MOE_B * MOE_T}
    config = {"bilstm_true": _no_dropout(serving_config()),
              "bilstm_grid": _no_dropout(serving_config(use_pallas_lstm="bi_grid")),
              "conformer": _dp_config("conformer"),
              "fused_encode": conformer_config(impl="fused")}[model]
    data = _random_corpus(config)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        idx = torch.as_tensor(rng.permutation(N_TRIALS)[:B_TRAIN], device="cuda")
        batch = {k: v[0][idx] for k, v in data.items()}
        batch["subject_idx"] = 0
        batches.append(batch)
    return {"config": config, "batches": batches, "tokens": B_TRAIN,
            "params": init_seq2seq(config, torch.Generator().manual_seed(0), "cuda")}


def _tp_pp_loss(model: str, config, modes=None, M: int = 0):
    """``loss_fn(params, batch, generator)`` of a case: the seq2seq loss (the
    encode under 'fused' for ``fused_encode``, whose first output it
    returns) or the long recording's ``Σ out·w``, under the case's parallel
    keywords ``modes`` (``Placement.modes``; one process without), each
    rank's share of it."""
    modes = modes or {}
    if model == "long":
        mesh = next((m[0] for m in modes.values()), None)
        share = 1.0 / mesh.size if mesh is not None else 1.0
        tp = modes.get("tp")

        def encode_long(p, b):
            if tp is not None:
                p = gather_params_tp(p, mesh, tp[2], tp[1])
            if "pp" in modes and "sp" in modes:
                return sp_pp_conformer_encode(p, config, b["x"], mesh, "seq", "pp", M,
                                              b["lengths"], torch.bfloat16)
            if "sp" in modes:
                return sequence_parallel_encode(p, config, b["x"], mesh, "seq", b["lengths"],
                                                torch.bfloat16)
            return conformer_encode(p, config, b["x"], b["lengths"],
                                    compute_dtype=torch.bfloat16)[0]

        return lambda p, b, g: (share * (encode_long(p, b).float() * b["w"]).sum(), {})
    if model == "fused_encode":
        return lambda p, b, g: encode(p, config, b["encoder_inputs"], b["encoder_lengths"], 0,
                                      tp=modes.get("tp"))[0]
    return lambda p, b, g: seq2seq_loss(p, config, b, None, train=False,
                                        penalty_scales=PENALTIES, **modes)


def _tp_pp_placement(mesh, tree, spec, config) -> Placement:
    """Where a case puts each leaf of ``tree`` (the whole tree) on its mesh."""
    _, (_, _, _, n_pp), _, split_by = spec
    return Placement(mesh, tree, tp=split_by == "tp", pp=n_pp > 1,
                     experts=config.conformer.moe_experts if split_by == "ep" else 0)


def _tp_pp_steps(problem: dict, loss_fn, params, mesh=None, split=None) -> dict:
    """A warm-up step (its summed gradients kept, before the clip) and a
    timed step of ``make_dp_train_step`` (clip 10, Adam, EMA); counts reset
    just before the timed step and read just after."""
    for t in tree_leaves(params):
        t.requires_grad_(True)
    ema = tree_map(lambda t: t.detach().clone(), params)
    optimizer = make_optimizer(params, TP_PP_LR)
    step = make_dp_train_step(loss_fn, 0.99, mesh, clip_norm=CLIP_NORM, split=split)
    first, grads = _summed_gradients(
        lambda: step(params, ema, optimizer, problem["batches"][0]))
    timer = StepTimer("cuda")
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    timer.start()
    second = step(params, ema, optimizer, problem["batches"][1])
    timer.lap(problem["tokens"])
    counts, bodies = read_counts(), read_bodies()
    # ------------------------------------------------------------------
    adam = optimizer.adam.state
    held = tree_leaves(params) + tree_leaves(ema) + [
        adam[p][k] for p in tree_leaves(params) for k in ("exp_avg", "exp_avg_sq")]
    return {"losses": [float(first[0]), float(second[0])], "grads": grads, "counts": counts,
            "bodies": bodies, "ms": 1e3 * timer.laps[0][0],
            "state_bytes": sum(t.numel() * t.element_size() for t in held),
            "param_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params))}


def tp_pp_references(root: str) -> dict:
    """The one-process run of every model the tp/pp cases use (the two steps,
    or the 'fused' encode), saved for the ranks to compare with."""
    out = {}
    models = {spec[0] for cases in TP_PP_CASES.values() for spec in cases.values()}
    for model in sorted(models):
        problem = _tp_pp_problem(model)
        params0 = tree_map(lambda t: t.detach().cpu().clone(), problem["params"])
        loss_fn = _tp_pp_loss(model, problem["config"])
        if model == "fused_encode":
            with torch.inference_mode():
                loss_fn(problem["params"], problem["batches"][0], None)
                timer = StepTimer("cuda")
                timer.start()
                enc = loss_fn(problem["params"], problem["batches"][0], None)
                timer.lap()
            ref = {"out": enc.float().cpu(), "ms": 1e3 * timer.laps[0][0], "params0": params0}
        else:
            r = _tp_pp_steps(problem, loss_fn, problem["params"])
            ref = {"grads": [g.cpu() for g in r["grads"]], "ms": r["ms"],
                   "losses": r["losses"], "param_bytes": r["param_bytes"],
                   "state_bytes": r["state_bytes"],
                   "delta": [t.detach().cpu() - t0 for t, t0 in
                             zip(tree_leaves(problem["params"]), tree_leaves(params0))],
                   "params0": params0}
        torch.save(ref, os.path.join(root, f"tp_pp_ref_{model}.pt"))
        out[model] = {k: ref[k] for k in ("ms", "losses", "param_bytes", "state_bytes")
                      if k in ref}
        del problem, ref, params0
        torch.cuda.empty_cache()
    return out


def _rank_tp_pp(root: str, name: str, spec: tuple) -> dict:
    """One case on this rank: its leaves before the steps against its part
    of the one-process parameters (bit for bit), the path's steps, then
    their checks against the one-process run (``tp_pp_references``): the
    summed first-step gradients and the parameters' change gathered whole
    (normwise), and a digest of its replicated leaves."""
    model, dims, M, _ = spec
    mesh = make_mesh(*dims)
    problem = _tp_pp_problem(model)
    config = problem["config"]
    placement = _tp_pp_placement(mesh, problem["params"], spec, config)
    params = placement.place(problem["params"])
    split = placement.split(params)
    ref = torch.load(os.path.join(root, f"tp_pp_ref_{model}.pt"))
    loss_fn = _tp_pp_loss(model, config, placement.modes(M or None), M)
    res = {"mesh": dict(mesh.shape),
           "placed_exactly": all(torch.equal(t.detach().cpu(), w) for t, w in zip(
               tree_leaves(params), tree_leaves(placement.place(ref["params0"]))))}
    if model == "fused_encode":
        with torch.inference_mode():
            loss_fn(params, problem["batches"][0], None)
            timer = StepTimer("cuda")
            reset_counts()
            timer.start()
            enc = loss_fn(params, problem["batches"][0], None)
            timer.lap()
            res["counts"], res["bodies"] = read_counts(), read_bodies()
        res["ms"] = 1e3 * timer.laps[0][0]
        res["out_err"] = _rel_norm_err([enc.float()], [ref["out"]])
        res["param_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        return res
    local0 = [t.detach().clone() for t in tree_leaves(params)]
    r = _tp_pp_steps(problem, loss_fn, params, mesh, split)
    grads = tree_leaves(placement.gather(_tree_of(params, r["grads"])))
    delta = tree_leaves(placement.gather(
        _tree_of(params, [t.detach() - t0 for t, t0 in zip(tree_leaves(params), local0)])))
    res.update({k: r[k] for k in ("losses", "counts", "bodies", "ms", "state_bytes",
                                  "param_bytes")})
    res["grad_rel_err"] = _rel_norm_err(grads, ref["grads"])
    res["delta_rel_err"] = _rel_norm_err(delta, ref["delta"])
    res["replicated_digest"] = _digest([t for t, s in zip(tree_leaves(params), split) if not s])
    return res


def _tree_of(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _tp_pp_expected(spec) -> dict:
    """A case's kernel launches on every rank: a full model's per step, or
    under pp the rank's blocks once a microbatch."""
    model, (_, _, _, n_pp), M, _ = spec
    if model == "bilstm_true":
        return dict(BILSTM_STEP)
    if model == "bilstm_grid":
        return {"K4f": len(serving_config().rnn_sizes), "K4b": len(serving_config().rnn_sizes)}
    nb = HEADLINE_CONFORMER["num_blocks"]
    if model == "fused_encode":
        return {"K3f": nb, "K5f": nb * LN_PER_BLOCK["fused"]}
    runs = nb // n_pp * (M if n_pp > 1 else 1)
    return {"K2f": runs, "K2b-dq": runs, "K2b-dkv": runs, "K5f": runs * LN_PER_BLOCK["flash"],
            "K5b": runs * LN_PER_BLOCK["flash"]}


def tp_pp_phase(ranks_by_world: dict, refs: dict) -> dict:
    """26-28. Tensor and pipeline parallelism and their compositions at full
    width, bf16, dropout off, seed 0, over gloo ranks that share the card
    (one spawn a world size): 26, tp=2 (the biLSTM benchmark model training
    under True and 'bi_grid', the headline conformer training under 'flash'
    and its 'fused' encode, B=256) and pp=2 (M=2); 27, on 4 ranks pp=4 (a
    block a stage, M=4), dp×tp, dp×pp, tp×sp and sp×pp on the long recording
    (B=16, T'=8192), ep×pp on the MoE cell and tp×pp; 28, on 8 ranks
    ep×sp×pp (groups of 128) and tp×sp×pp (the long recording), each 2×2×2.
    Each case against one process: the first step's summed gradients
    (normwise, GRAD_REL_TOL) and the parameters' change after two steps
    (DP_DELTA_TOL), gathered whole; every rank's own leaves before the
    steps equal to its part of the one-process parameters; the replicated leaves
    bit-identical over the ranks; each rank's launches of the path's kernels
    (exactly); each rank's step time and the bytes of its parameters and
    its whole training state, beside the pipeline bubble (S−1)/(M+S−1)."""
    results = {}
    for world, cases in TP_PP_CASES.items():
        for i, (name, spec) in enumerate(cases.items()):
            rr = [r[i] for r in ranks_by_world[world]]
            model, dims, M, _ = spec
            want = _tp_pp_expected(spec)
            _check_rank_counts(name, rr, lambda r: r["counts"], want, 1)
            for k in want:
                if k in BODIES and k != "K5b":
                    body = "cluster" if k in LSTM_BODIES else "tensor_core"
                    for j, r in enumerate(rr):
                        check_bodies(f"{name} rank {j}", r["bodies"], k, body, r["counts"][k])
            S = dims[3]
            bubble = (S - 1) / (M + S - 1) if S > 1 else 0.0
            ref = refs[model]
            out = {"counts_by_rank": [r["counts"] for r in rr], "ms_by_rank":
                   [r["ms"] for r in rr], "param_bytes_by_rank": [r["param_bytes"] for r in rr],
                   "one_process_ms": ref["ms"], "bubble": bubble, "mesh": rr[0]["mesh"]}
            check(all(r["placed_exactly"] for r in rr),
                  f"{name}: a rank's leaves are not its part of one process's")
            if model == "fused_encode":
                err = max(r["out_err"] for r in rr)
                check(err <= TOL[torch.bfloat16]["rtol"],
                      f"{name}: encode off by {err:.3e} of its norm")
                out["out_rel_err"] = err
            else:
                gerr = max(r["grad_rel_err"] for r in rr)
                derr = max(r["delta_rel_err"] for r in rr)
                check(gerr <= GRAD_REL_TOL, f"{name}: summed gradients off by {gerr:.3e} of "
                                            f"their norm (limit {GRAD_REL_TOL})")
                check(derr <= DP_DELTA_TOL, f"{name}: parameter change off by {derr:.3e} "
                                            f"of its norm (limit {DP_DELTA_TOL})")
                check(len({r["replicated_digest"] for r in rr}) == 1,
                      f"{name}: the ranks' replicated leaves differ")
                out.update({"grad_rel_err": gerr, "delta_rel_err": derr,
                            "state_bytes_by_rank": [r["state_bytes"] for r in rr],
                            "one_process_state_bytes": ref["state_bytes"],
                            "losses": rr[0]["losses"], "one_process_losses": ref["losses"]})
            results[name] = out
            errs = {k: f"{out[k]:.3e}" for k in ("grad_rel_err", "delta_rel_err",
                                                 "out_rel_err") if k in out}
            print(f"{name} {out['mesh']} ({model}, M={M or '-'}): {errs}; step ms by rank "
                  + ", ".join(f"{x:.2f}" for x in out["ms_by_rank"])
                  + f" (one process {ref['ms']:.2f}); parameter bytes by rank "
                  f"{out['param_bytes_by_rank']} (one process {ref.get('param_bytes', '-')}); "
                  f"expected bubble {bubble:.3f}; launches per rank {want}  [{gpu_line()}]")
    return results


# --------------------------------------------------------------------------
# 30. the examples: the user entry points of ``ecog2txt_tpu_torch.examples``
# --------------------------------------------------------------------------

# run_mocha_scale at full width for this many epochs (two assessments)
MOCHA_EPOCHS = 20
# the flash run of stream_long_recording and the MoE ranks: epochs enough to
# train through the kernels (their checks hold at any epoch)
FLASH_STREAM_EPOCHS = 20
MOE_EPOCHS = 10


def _only(path: str, counts: dict, launched: tuple) -> None:
    """Every kernel in ``launched`` ran on ``path``, no other one."""
    check(all(counts[k] > 0 for k in launched)
          and all(v == 0 for k, v in counts.items() if k not in launched),
          f"{path}: kernel launches {counts}, expected {launched} and no other")


def _loss_by_interval(logdir: str) -> list:
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    by_step: dict = {}
    for event in iter_events(path):
        by_step.setdefault(event["step"], {}).update(event.get("scalars", {}))
    return [by_step[s]["loss/total"] for s in sorted(by_step) if "loss/total" in by_step[s]]


def mocha_example_phase(root: str) -> dict:
    """30a. ``examples.run_mocha_scale`` at full width (16x16 grid, 450
    training trials, conv 100 / 12, 3x400 biLSTM, aux 225, decoder 150 /
    800, B=128, bf16, True) for ``MOCHA_EPOCHS`` epochs: K1f 6 x (steps +
    assessment encodes) and K1b 6 x steps exactly, all on the cluster
    bodies; the mean loss of the last assessment interval below the
    first's."""
    logdir = os.path.join(root, "mocha_tb")
    t0 = time.perf_counter()
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    out = run_mocha_scale.main([os.path.join(root, "mocha"), "--epochs", str(MOCHA_EPOCHS)],
                               SN_kwargs={"tf_summaries_dir": logdir})
    counts, bodies = read_counts(), read_bodies()
    # ------------------------------------------------------------------
    s = time.perf_counter() - t0
    trainer = out["trainer"]
    cfg = trainer.net_config
    check((cfg.rnn_sizes, cfg.dec_rnn_sizes, cfg.conv_sizes, cfg.compute_dtype,
           cfg.use_pallas_lstm, trainer.batch_size, cfg.in_channels)
          == ((400, 400, 400), (800,), (100,), torch.bfloat16, True, 128, 256),
          f"mocha example: config {cfg}")
    encodes = 2 * len(out["history"])  # training and validation, one encode each
    layers = len(cfg.rnn_sizes) * 2
    check_counts("mocha example", counts, {"K1f": layers * (out["steps"] + encodes),
                                           "K1b": layers * out["steps"]})
    check_bodies("mocha example", bodies, "K1f", "cluster", counts["K1f"])
    check_bodies("mocha example", bodies, "K1b", "cluster", counts["K1b"])
    losses = _loss_by_interval(logdir)
    check(len(losses) == len(out["history"]) and all(np.isfinite(losses))
          and losses[-1] < losses[0], f"mocha example: loss by interval {losses}")
    print(f"mocha example (full width, B=128, bf16, True): {MOCHA_EPOCHS} epochs, "
          f"{out['steps']} steps, {encodes} assessment encodes in {out['wall_s']:.1f} s "
          f"(data set-up {out['setup_s']:.1f} s, {s:.1f} s in all); {out['step_ms']:.2f} ms "
          f"a step; loss by interval "
          f"{losses}; final WERs {out['wers']}; launches {counts}  [{gpu_line()}]")
    return {"counts": counts, "bodies": bodies, "epochs": MOCHA_EPOCHS,
            **{k: out[k] for k in ("steps", "wall_s", "setup_s", "step_ms", "wers",
                                   "epochs_to_wer_0")},
            "assessments": len(out["history"]), "losses": losses, "s": s}


def stream_example_phase(root: str) -> dict:
    """30b. ``examples.stream_long_recording`` at its defaults ('auto':
    dense attention at these lengths; K5f and K5b) and under 'flash' (K2f,
    K2b-dq, K2b-dkv as well): every sentence's streamed tokens equal its
    offline decode (the example exits 1 otherwise)."""
    runs = {}
    for impl, epochs, launched in (
            ("auto", None, ("K5f", "K5b")),
            ("flash", FLASH_STREAM_EPOCHS, ("K2f", "K2b-dq", "K2b-dkv", "K5f", "K5b"))):
        argv = [os.path.join(root, f"stream_{impl}")]
        argv += ["--epochs", str(epochs)] if epochs else []
        sn = {"conformer": {"attention_impl": impl}} if impl != "auto" else None
        t0 = time.perf_counter()
        # ---- the main path: counts reset just before, read just after ----
        reset_counts()
        out = stream_long_recording.main(argv, SN_kwargs=sn)
        counts = read_counts()
        # ------------------------------------------------------------------
        s = time.perf_counter() - t0
        n = len(out["sentences"])
        check(n == 8 and out["matches"] == n, f"stream example {impl}: {out['matches']}/{n}")
        _only(f"stream example {impl}", counts, launched)
        print(f"stream example ({impl}, {epochs or 120} epochs): streamed == offline for "
              f"{n}/{n}; final training WER {out['final_training_wer']:.3f}; median warm "
              f"real-time factor {out['rtf_warm']:.1f}x; {s:.1f} s; launches {counts}")
        runs[impl] = {"counts": counts, "s": s, "rtf_warm": out["rtf_warm"],
                      "final_training_wer": out["final_training_wer"]}
    return runs


def pool_example_phase(root: str) -> dict:
    """30c. ``examples.serve_pool`` at its defaults: every stream's pooled
    hypothesis equals a dedicated session's and the offline decode's (the
    example exits 1 otherwise); K5f and K5b, no attention kernel (the pool
    pins 'dense', the demo lengths pick it)."""
    t0 = time.perf_counter()
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    out = serve_pool.main([os.path.join(root, "pool")])
    counts = read_counts()
    # ------------------------------------------------------------------
    s = time.perf_counter() - t0
    check(len(out["streams"]) == 3 and all(x["agree"] for x in out["streams"]),
          f"pool example: {out['streams']}")
    _only("pool example", counts, ("K5f", "K5b"))
    print(f"pool example: 3/3 streams pooled == dedicated == offline; {s:.1f} s; "
          f"launches {counts}")
    return {"counts": counts, "s": s}


def raw_example_phase(root: str) -> dict:
    """30d. ``examples.raw_voltage_demo`` under ``use_pallas_lstm='bi_grid'``
    at its defaults (150 epochs, f32): the JAX bounds (validation WER at
    most 0.25, streamed featurization within 1e-3 of offline), 3 K4f an
    encode and 3 K4b a step (2 layers here: one a layer), no other kernel."""
    t0 = time.perf_counter()
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    out = raw_voltage_demo.main([os.path.join(root, "raw")],
                                SN_kwargs={"use_pallas_lstm": "bi_grid"})
    counts = read_counts()
    # ------------------------------------------------------------------
    s = time.perf_counter() - t0
    trainer = out["trainer"]
    steps = trainer.N_epochs * run_mocha_scale.steps_per_epoch(trainer)
    # two encodes an assessment, every interval, and the final two partitions
    encodes = 2 * (trainer.N_epochs // trainer.assessment_epoch_interval) + 2
    layers = len(trainer.net_config.rnn_sizes)
    check_counts("raw example", counts, {"K4f": layers * (steps + encodes),
                                         "K4b": layers * steps})
    check(out["wer"] <= 0.25 and out["stream_err"] < 1e-3,
          f"raw example: WER {out['wer']}, streamed featurization {out['stream_err']}")
    print(f"raw-voltage example ('bi_grid', f32): {out['n_trials']} trials; validation WER "
          f"{out['wer']:.3f}, testing {out['out']['testing']['word_error_rate']:.3f}; "
          f"streamed featurization max |err| {out['stream_err']:.2e}; {s:.1f} s; "
          f"launches {counts}")
    return {"counts": counts, "s": s, "wer": out["wer"], "stream_err": out["stream_err"]}


def moe_example_rank(argv: list) -> dict:
    """One rank of phase 30e: ``examples.moe_expert_parallel.main`` with the
    launches it made."""
    reset_counts()
    out = moe_expert_parallel.main(argv)
    return {"counts": read_counts(), "mesh": out["mesh"], "final_wer": out["final_wer"],
            "tokens": out["tokens"], "offline": out["offline"]}


def moe_example_phase(root: str) -> dict:
    """30e. ``examples.moe_expert_parallel`` on 4 gloo ranks sharing the
    card (``parallel.launch.spawn``): the experts over 4 ranks (data 1 x
    model 4); on every rank the streamed decode equals the offline one, and
    K5f and K5b ran, no other kernel."""
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:moe_example_rank", 4,
                  {"argv": [os.path.join(root, "moe"), "--epochs", str(MOE_EPOCHS)]},
                  timeout=RANK_TIMEOUT, backend="gloo", device="cuda",
                  pythonpath=[os.path.dirname(os.path.abspath(__file__))])
    s = time.perf_counter() - t0
    for i, r in enumerate(ranks):
        check(r["mesh"] == {"data": 1, "model": 4}, f"moe example rank {i}: mesh {r['mesh']}")
        check(np.array_equal(r["tokens"], r["offline"]), f"moe example rank {i}: streamed "
              "decode differs from offline")
        _only(f"moe example rank {i}", r["counts"], ("K5f", "K5b"))
    print(f"MoE example (4 gloo ranks, experts over 4, {MOE_EPOCHS} epochs): streamed == "
          f"offline on every rank; final val WER {ranks[0]['final_wer']:.3f}; {s:.1f} s; "
          f"launches by rank {[r['counts'] for r in ranks]}")
    return {"counts_by_rank": [r["counts"] for r in ranks], "s": s}


def migrate_example_phase(root: str) -> dict:
    """30f. ``examples.migrate_from_reference`` at its defaults (the
    packaged manifest, the stand-in TF1 source: a mapping, since tensorflow
    is not on the card's machine): every variable imported, the architecture
    read from the source equal to the trainer's, the exported program's
    tokens equal to the predictor's; K1f and K1b (True), no other kernel."""
    t0 = time.perf_counter()
    # ---- the main path: counts reset just before, read just after ----
    reset_counts()
    out = migrate_from_reference.main([os.path.join(root, "migrate")])
    counts = read_counts()
    # ------------------------------------------------------------------
    s = time.perf_counter() - t0
    cfg, sizes = out["trainer"].net_config, out["recovered"]["layer_sizes"]
    check("tensorflow is not installed" in out["tf1_source"],
          f"migrate example: expected the mapping stand-in, got {out['tf1_source']}")
    check(out["report"]["skipped"] == [] and len(out["report"]["imported"]) > 0,
          f"migrate example: import report {out['report']}")
    check((list(cfg.conv_sizes), list(cfg.rnn_sizes), list(cfg.dec_rnn_sizes))
          == (sizes["encoder_embedding"], sizes["encoder_rnn"], sizes["decoder_rnn"]),
          f"migrate example: recovered {sizes}, trainer {cfg}")
    check(np.array_equal(out["exported_tokens"], out["tokens"]),
          "migrate example: exported tokens differ")
    _only("migrate example", counts, ("K1f", "K1b"))
    print(f"migrate example: {out['tf1_source']}; {len(out['report']['imported'])} variables "
          f"imported, architecture {sizes}; validation WER {out['wer']:.3f}; exported "
          f"tokens == predictor's; {s:.1f} s; launches {counts}")
    return {"counts": counts, "s": s, "wer": out["wer"],
            "variables": len(out["report"]["imported"])}


def examples_phase(root: str) -> dict:
    """30. Every example of ``ecog2txt_tpu_torch.examples`` through its
    ``main``, on the card."""
    t0 = time.perf_counter()
    out = {"mocha": mocha_example_phase(root), "stream": stream_example_phase(root),
           "pool": pool_example_phase(root), "raw": raw_example_phase(root),
           "moe": moe_example_phase(root), "migrate": migrate_example_phase(root)}
    out["s"] = time.perf_counter() - t0
    print(f"phase 30 (the examples): {out['s']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a GPU",
              file=sys.stderr)
        return 2
    # cuBLAS's workspace fixed before its first call (32 MiB, its default on
    # Hopper), so phase 25b can ask for deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    env = environment()
    with tempfile.TemporaryDirectory() as root:
        trainer = demo_trainer(root)
        conf_trainer = demo_conformer_trainer(root)
        demo_shapes = trainer_kernel_shapes(trainer)
        conf_shape = conformer_trainer_shape(conf_trainer)
        print(f"demo trainer kernel shapes (B, H, T'): {demo_shapes}; conformer demo "
              f"trainer attention shape (B, T', D, H, C, L): {conf_shape}")
        wait_built(env, ("device_info", "lstm_recurrence", "lstm_recurrence_bwd",
                         "lstm_bwd_cluster", "bilstm_grid", "layer_norm"))
        kern = kernel_phase(demo_shapes)
        kern_b = kernel_bwd_phase(demo_shapes)
        gridk = grid_and_layernorm_kernel_phase(demo_shapes)
        wait_built(env)  # nothing compiles while the main paths are timed
        by_shape = _fwd_bodies_by_shape(
            [(16, H, T_STEPS), *demo_shapes, *((1, h, steps) for _, h, steps in demo_shapes),
             (256, 64, T_STEPS)])
        attn = attention_kernel_phase(conf_shape)
        serve = serving_phase()
        train = training_phase()
        trainer_out = trainer_phase(trainer)
        gserve = grid_serving_phase()
        gtrain = grid_training_phase()
        conf_params = init_seq2seq(conformer_config(), torch.Generator().manual_seed(0),
                                   device="cuda")
        cserve = conformer_serving_phase(conf_params)
        cstream = conformer_stream_phase(conf_params)
        ctrain = conformer_training_phase(conf_params)
        clong = long_recording_phase(conf_params)
        ctrainer = conformer_trainer_phase(conf_trainer)
        beam = beam_phase(conf_params)
        del conf_params
        ctc_params = init_seq2seq(ctc_config(), torch.Generator().manual_seed(0), device="cuda")
        session = session_phase(ctc_params)
        pool = pool_phase(ctc_params)
        ctc_train = ctc_training_phase(ctc_params)
        exported = export_phase()
        moe_serve = moe_serving_phase()
        moe_train = moe_training_phase()
        int8 = int8_serving_phase(ctc_params)
        feat = featurization_phase()
        raw_session = raw_session_phase(ctc_params)
        del ctc_params
        tools, tools_trainer, tools_manifest = trainer_tools_phase(root)
        sweeps = sweeps_phase(tools_trainer, tools_manifest)
        del tools_trainer
        cexport, flash_program = conformer_export_phase()
        tf32 = tf32_phase(flash_program)
        del flash_program
        torch.cuda.empty_cache()
        # phases 22-24 and 26-28: the one-process runs of 26-28 first, then
        # the ranks run their phases (one spawn a world size), then this
        # process checks them against one process
        tp_pp_refs = tp_pp_references(root)
        tp_pp = {w: [f"tp_pp:{n}" for n in cases] for w, cases in TP_PP_CASES.items()}
        two, d2 = _spawn(2, ["dp_conformer", "dp_bilstm", "sp", "ep", *tp_pp[2]], root,
                         "gloo")
        four, d4 = _spawn(4, ["ep_sp", *tp_pp[4]], root, "gloo")
        eight, _ = _spawn(8, tp_pp[8], root, "gloo")
        one, d1 = _nccl_world_of_one(root)
        dp = dp_phase([("gloo x2", two, d2), ("nccl x1", one, d1)])
        sp = sp_phase(two, d2)
        ep = ep_phase([("ep2", two, d2, 1), ("ep2_sp2", four, d4, 2)])
        tpp = tp_pp_phase({w: [[r[p] for p in tp_pp[w]] for r in ranks]
                           for w, ranks in ((2, two), (4, four), (8, eight))}, tp_pp_refs)
        twin = demo_twin_phase(root)
        quality = decode_quality_phase(root)
        examples = examples_phase(root)
    t256, t1 = kern["timings"][256], kern["timings"][1]
    b256 = kern_b["timings"][256]
    nb = HEADLINE_CONFORMER["num_blocks"]
    headline = "B=256 T'=104 (T1=128) D=384 H=6 C=16 L=1 bf16"
    source = "ecog2txt_tpu_torch/csrc/banded_attention.cu"
    bwd_source = "ecog2txt_tpu_torch/csrc/banded_attention_bwd_tc.cu"
    pallas = "ecog2txt_tpu/ops/pallas_attention.py"

    def attention_entry(name, key, src, replaces, launches, extra):
        th, tl = attn["timings"]["headline"][key], attn["timings"]["long"][key]
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, **extra,
            "max_abs_err": max(attn["errs"][key].values()),
            "max_abs_err_f32": attn["errs"][key][torch.float32],
            "max_abs_err_bf16": attn["errs"][key][torch.bfloat16],
            "max_abs_err_function_grads_f32": attn["grad_err"],
            "shape": headline,
            "ms": th["ms"], "plain_ms": th["plain_ms"], "bound_ms": th["bound_ms"],
            "bound_by": th["bound_by"], "library_ms": th["library_ms"],
            "build_s": env["build_s"],
            "at_long": {"shape": f"B={LONG_B} T'={LONG_T} D=384 H=6 bf16", **tl},
        }

    def grid_entry(name, key, replaces, launches, extra):
        t256, t1 = gridk["timings"][256][key], gridk["timings"][1][key]
        return {
            "name": name, "route": "cuda", "source": "ecog2txt_tpu_torch/csrc/bilstm_grid.cu",
            "replaces": replaces, "launches": launches, **extra,
            "max_abs_err": max(gridk["errs"][key].values()),
            "max_abs_err_f32": gridk["errs"][key][torch.float32],
            "max_abs_err_bf16": gridk["errs"][key][torch.bfloat16],
            "max_abs_err_function_grads_f32": gridk["grid_grad_err"],
            "shape": f"T'={T_STEPS} B=256 H={H} bf16, both directions",
            "ms": t256["ms"], "plain_ms": t256["plain_ms"], "bound_ms": t256["bound_ms"],
            "bound_by": t256["bound_by"], "library_ms": t256["library_ms"],
            "build_s": env["build_s"], "at_batch_1": t1,
        }

    def ln_entry(name, key, replaces, launches, extra):
        th, tl = gridk["ln_timings"]["headline"][key], gridk["ln_timings"]["long"][key]
        return {
            "name": name, "route": "cuda", "source": "ecog2txt_tpu_torch/csrc/layer_norm.cu",
            "replaces": replaces, "launches": launches, **extra,
            "max_abs_err": max(gridk["errs"][key].values()),
            "max_abs_err_f32": gridk["errs"][key][torch.float32],
            "max_abs_err_bf16": gridk["errs"][key][torch.bfloat16],
            "max_abs_err_function_grads_f32": gridk["ln_grad_err"],
            "shape": f"rows=B*T'={256 * T_STEPS} D=384 bf16",
            "ms": th["ms"], "plain_ms": th["plain_ms"], "bound_ms": th["bound_ms"],
            "bound_by": th["bound_by"], "library_ms": th["library_ms"],
            "build_s": env["build_s"],
            "at_long": {"shape": f"rows={LONG_B * LONG_T} D=384 bf16", **tl},
        }

    pallas_lstm = "ecog2txt_tpu/ops/pallas_lstm.py"
    pallas_ln = "ecog2txt_tpu/ops/pallas_layernorm.py"
    layers = len(serving_config().rnn_sizes)
    new_entries = [
        grid_entry("bilstm_grid_fwd", "K4f", f"{pallas_lstm}:643", gserve["counts"]["K4f"], {
            "launches_per_request": ENCODES_PER_CALL * layers,
            "launches_training": gtrain["counts"]["K4f"],
            "two_k1f_ms": gridk["timings"][256]["K4f"]["two_k1f_ms"],
            "body": "cluster for bf16 where the weight slice fits (K1f's body, "
                    "csrc/lstm_fwd_cluster.cuh, with a direction axis), rows otherwise",
            "launches_by_body": {"bi_grid_serving": gserve["bodies"]["K4f"],
                                 "bi_grid_training": gtrain["bodies"]["K4f"]},
            "ms_rows_body": gridk["timings"][256]["K4f"]["ms_rows_body"],
            "rows_per_block": gridk["timings"][256]["K4f"]["rows_per_block"],
            "ms_by_rows_per_cluster": gridk["timings"][256]["K4f"]["ms_by_rows_per_cluster"],
            "plan": gridk["timings"][256]["K4f"]["plan"],
            "library": "cuDNN bidirectional nn.LSTM forward (one input for both directions)"}),
        grid_entry("bilstm_grid_bwd", "K4b", f"{pallas_lstm}:805", gtrain["counts"]["K4b"], {
            "launches_per_step": layers,
            "two_k1b_ms": gridk["timings"][256]["K4b"]["two_k1b_ms"],
            "body": "cluster for bf16 where the weight slice fits (K1b's body, "
                    "csrc/lstm_bwd_cluster.cuh, with a direction axis), rows otherwise",
            "launches_by_body": {"bi_grid_training": gtrain["bodies"]["K4b"]},
            "ms_launch_only": gridk["timings"][256]["K4b"]["ms_launch_only"],
            "ms_rows_body": gridk["timings"][256]["K4b"]["ms_rows_body"],
            "plan": gridk["timings"][256]["K4b"]["plan"],
            "library": "cuDNN bidirectional nn.LSTM backward, (forward+backward)-forward; "
                       "also computes the weight gradients"}),
        ln_entry("layer_norm_fwd", "K5f", f"{pallas_ln}:100",
                 cserve["flash"]["counts"]["K5f"], {
                     "launches_per_request": {
                         impl: ENCODES_PER_CALL * nb * LN_PER_BLOCK[impl]
                         for impl in ("flash", "fused")},
                     "launches_fused_serving": cserve["fused"]["counts"]["K5f"],
                     "launches_stream": cstream["counts"]["K5f"],
                     "launches_training": ctrain["flash"]["counts"]["K5f"],
                     "launches_training_fused": ctrain["fused"]["counts"]["K5f"],
                     "launches_long": clong["counts"]["K5f"],
                     "launches_demo_trainer": ctrainer["counts"]["K5f"],
                     "ms_is": "device time (torch.profiler), as library_ms",
                     "library": "F.layer_norm forward (bf16 affine parameters)"}),
        ln_entry("layer_norm_bwd", "K5b", f"{pallas_ln}:119",
                 ctrain["flash"]["counts"]["K5b"], {
                     "launches_per_step": nb * LN_PER_BLOCK["flash"],
                     "launches_training_fused": ctrain["fused"]["counts"]["K5b"],
                     "launches_long": clong["counts"]["K5b"],
                     "launches_demo_trainer": ctrainer["counts"]["K5b"],
                     "flash_step_ms_plain_layernorm": ctrain["plain_layernorm"]["plain_ms"],
                     "flash_step_ms_k5": ctrain["plain_layernorm"]["K5_ms"],
                     "body": "registers (a row in a warp's registers, read once) where a lane "
                             "holds at most 4 chunks of the row, columns otherwise",
                     "launches_by_body": {
                         "flash_training": ctrain["flash"]["bodies"]["K5b"],
                         "fused_training": ctrain["fused"]["bodies"]["K5b"],
                         "long": clong["bodies"]["K5b"],
                         "demo_trainer": ctrainer["bodies"]["K5b"]},
                     "ms_is": "registers body + the sum of its partials (two launches)",
                     "ms_registers_body_alone": gridk["ln_timings"]["headline"]["K5b"][
                         "ms_registers_body_alone"],
                     "ms_columns_body_alone": gridk["ln_timings"]["headline"]["K5b"][
                         "ms_columns_body_alone"],
                     "library": "F.layer_norm backward: device time of (forward+backward) - "
                                "forward, no gradient accumulation"}),
    ]
    sdpa = "scaled_dot_product_attention with a boolean band mask"
    attention_entries = [
        attention_entry("banded_attention_fwd", "K2f",
                        "ecog2txt_tpu_torch/csrc/banded_attention_tc.cu", f"{pallas}:321",
                        cserve["flash"]["counts"]["K2f"], {
                            "launches_per_request": ENCODES_PER_CALL * nb,
                            "launches_stream": cstream["counts"]["K2f"],
                            "launches_training": ctrain["flash"]["counts"]["K2f"],
                            "launches_long": clong["counts"]["K2f"],
                            "launches_demo_trainer": ctrainer["counts"]["K2f"],
                            "body": "tensor_core for bf16 (csrc/banded_attention_tc.cu), "
                                    "cuda_core for f32",
                            "launches_by_body": {
                                "flash_serving": cserve["flash"]["bodies"]["K2f"],
                                "stream_f32": cstream["bodies"]["K2f"],
                                "flash_training": ctrain["flash"]["bodies"]["K2f"],
                                "long": clong["bodies"]["K2f"],
                                "demo_trainer": ctrainer["bodies"]["K2f"]},
                            "ms_cuda_core_body": attn["timings"]["headline"]["K2f"][
                                "ms_cuda_core_body"],
                            "library": f"{sdpa}, forward"}),
        *(attention_entry(f"banded_attention_{key[4:]}", key, bwd_source, f"{pallas}:{line}",
                          ctrain["flash"]["counts"][key], {
                              "launches_per_step": nb,
                              "launches_training_fused": ctrain["fused"]["counts"][key],
                              "launches_long": clong["counts"][key],
                              "launches_demo_trainer": ctrainer["counts"][key],
                              "body": "tensor_core for bf16 (csrc/banded_attention_bwd_tc.cu), "
                                      "cuda_core for f32 (csrc/banded_attention.cu)",
                              "launches_by_body": {
                                  "flash_training": ctrain["flash"]["bodies"][key],
                                  "fused_training": ctrain["fused"]["bodies"][key],
                                  "long": clong["bodies"][key],
                                  "demo_trainer": ctrainer["bodies"][key]},
                              "ms_cuda_core_body": attn["timings"]["headline"][key][
                                  "ms_cuda_core_body"],
                              "dq_plus_dkv_ms": attn["timings"]["headline"]["K2b_sum"]["ms"],
                              "max_abs_err_flash_head_dim_256": attn["flash_head_dim_256"],
                              "library": f"{sdpa}, (forward+backward)-forward; one backward "
                                         "computes dq, dk and dv together"})
          for key, line in (("K2b-dq", 290), ("K2b-dkv", 302))),
        attention_entry("fused_attention_fwd", "K3f",
                        "ecog2txt_tpu_torch/csrc/fused_attention_tc.cu", f"{pallas}:550",
                        cserve["fused"]["counts"]["K3f"], {
                            "launches_per_request": ENCODES_PER_CALL * nb,
                            "launches_training": ctrain["fused"]["counts"]["K3f"],
                            "ms_with_residuals": attn["timings"]["headline"]["K3f"][
                                "ms_with_residuals"],
                            "max_abs_err_head_dim_above_256": attn["k3f_wide_head"],
                            "body": "tensor_core for bf16 (csrc/fused_attention_tc.cu), "
                                    "cuda_core for f32 (csrc/fused_attention.cu)",
                            "launches_by_body": {
                                "fused_serving": cserve["fused"]["bodies"]["K3f"],
                                "fused_training": ctrain["fused"]["bodies"]["K3f"]},
                            "ms_cuda_core_body": attn["timings"]["headline"]["K3f"][
                                "ms_cuda_core_body"],
                            "at_batch_1": attn["timings"]["k3f_batch_1"],
                            "library": "none: no single library call computes LayerNorm, "
                                       "the rotary projections and the banded attention"}),
    ]
    line = {"kernels": [{
        "name": "lstm_recurrence_fwd",
        "route": "cuda",
        "source": "ecog2txt_tpu_torch/csrc/lstm_recurrence.cu",
        "replaces": "ecog2txt_tpu/ops/pallas_lstm.py:215",
        "launches": serve["launches"],
        "launches_per_request": ENCODES_PER_CALL * LAUNCHES_PER_ENCODE,
        "launches_training": train["fwd"],
        "max_abs_err": max(kern["errs"].values()),
        "max_abs_err_f32": kern["errs"][torch.float32],
        "max_abs_err_bf16": kern["errs"][torch.bfloat16],
        "shape": f"T'={T_STEPS} B=256 H={H} bf16",
        "ms": t256["ms"], "plain_ms": t256["plain_ms"],
        "bound_ms": t256["bound_ms"], "bound_by": t256["bound_by"],
        "library_ms": t256["library_ms"],
        "library": "cuDNN nn.LSTM forward",
        "body": "cluster for bf16 where the weight slice fits "
                "(csrc/lstm_fwd_cluster.cuh), rows otherwise",
        "launches_by_body": {"serving": serve["bodies"]["K1f"],
                             "training": train["bodies"]["K1f"],
                             "demo_trainer": trainer_out["bodies"]["K1f"]},
        "ms_rows_body": t256["ms_rows_body"], "rows_per_block": t256["rows_per_block"],
        "ms_by_rows_per_cluster": t256["ms_by_rows_per_cluster"], "plan": t256["plan"],
        "bodies_ms_by_shape": by_shape,
        "build_s": env["build_s"],
        "at_batch_1": t1,
    }, {
        "name": "lstm_recurrence_bwd",
        "route": "cuda",
        "source": "ecog2txt_tpu_torch/csrc/lstm_bwd_cluster.cu",
        "replaces": "ecog2txt_tpu/ops/pallas_lstm.py:380",
        "launches": train["bwd"],
        "launches_per_step": LAUNCHES_PER_ENCODE,
        "max_abs_err": max(kern_b["errs"].values()),
        "max_abs_err_f32": kern_b["errs"][torch.float32],
        "max_abs_err_bf16": kern_b["errs"][torch.bfloat16],
        "max_abs_err_function_grads_f32": kern_b["grad_err"],
        "shape": f"T'={T_STEPS} B=256 H={H} bf16",
        "ms": b256["ms"], "plain_ms": b256["plain_ms"],
        "bound_ms": b256["bound_ms"], "bound_by": b256["bound_by"],
        "library_ms": b256["library_ms"],
        "library": "cuDNN nn.LSTM backward, (forward+backward)-forward; also "
                   "computes the weight gradients",
        "body": "cluster for bf16 where the weight slice fits "
                "(csrc/lstm_bwd_cluster.cu), rows otherwise",
        "launches_by_body": {"training": train["bodies"]["K1b"],
                             "demo_trainer": trainer_out["bodies"]["K1b"]},
        "ms_rows_body": b256["ms_rows_body"], "plan": b256["plan"],
        "build_s": env["build_s"],
        "at_batch_16": kern_b["timings"][16],
    }, *attention_entries, *new_entries], "training_step_ms": train["ms"],
        "training_sentences_per_s": B_TRAIN / (train["ms"] / 1e3),
        "conformer": {
            impl: {"request_ms_b1": 1e3 * cserve[impl]["latency_s"],
                   "sentences_per_s_b256": 256 / cserve[impl]["batch_s"],
                   "training_step_ms": ctrain[impl]["ms"],
                   "training_sentences_per_s": B_TRAIN / (ctrain[impl]["ms"] / 1e3)}
            for impl in ("flash", "fused")
        },
        "bi_grid": {"request_ms_b1": 1e3 * gserve["latency_s"],
                    "sentences_per_s_b256": 256 / gserve["batch_s"],
                    "training_step_ms": gtrain["ms"],
                    "training_sentences_per_s": B_TRAIN / (gtrain["ms"] / 1e3)},
        "long_recording": {"train_tokens_per_s": clong["train_tokens_per_s"],
                           "forward_tokens_per_s": clong["fwd_tokens_per_s"]},
        "conformer_demo_wers": ctrainer["wers"],
        "beam": {mode: {k: v for k, v in r.items() if k not in ("counts", "bodies")}
                 for mode, r in beam.items()},
        "session": {impl: {k: session[impl][k] for k in
                           ("chunk_ms", "partial_greedy_ms", "partial_lexicon_ms", "encodes")}
                    for impl in ("flash", "fused")},
        "pool": {"capacity": 8, "tick_ms": pool["tick_ms"], "ticks": pool["ticks"]},
        "ctc_training": {"step_ms": ctc_train["ms"],
                         "sentences_per_s": B_TRAIN / (ctc_train["ms"] / 1e3),
                         "ctc_loss_fwd_ms": ctc_train["ctc_loss_fwd_ms"]},
        "export_s": {mode: r["export_s"] for mode, r in exported.items()},
        "moe": {"serving": {impl: {"request_ms_b1": 1e3 * moe_serve[impl]["latency_s"],
                                   "sentences_per_s_b256": 256 / moe_serve[impl]["batch_s"]}
                            for impl in ("flash", "fused")},
                "moe_aux_b256": moe_serve["moe_aux"],
                "training": {k: moe_train[k] for k in ("ms", "tokens_per_s", "peak_gib")}},
        "int8": {"gemm_ms": int8["gemm_ms"], "encode_b256_ms": int8["encode_ms"],
                 "cosine_vs_float": int8["cos"], "max_abs_err_over_max": int8["rel_max"],
                 "session_chunk_ms": {i: int8[i]["chunk_ms"] for i in ("flash", "fused")}},
        "featurization": feat,
        "raw_session": {k: raw_session[k] for k in ("push_ms", "partial_ms", "encodes",
                                                    "packets")},
        "trainer_tools": {
            "setup_s": tools["setup_s"],
            "curriculum": {k: tools["curriculum"][k] for k in ("total_s", "steps", "fit_s",
                                                                "wers")},
            "rollback_s": tools["rollback"]["s"], "recovery_assess_s": tools["recovery"]["s"],
            "tf1_import_s": tools["tf1"]["s"], "saliencies_s": tools["analysis"]["sal_s"],
            "activations_s": tools["analysis"]["act_s"],
            "saliency_f32_err": tools["analysis"]["sal_err"],
            "activations_f32_err": tools["analysis"]["act_err"],
            "lazy_shards": {k: tools["lazy"][k] for k in ("host_s", "device_s", "err", "shard")}},
        "conformer_export_s": {name: r["export_s"] for name, r in cexport.items()},
        "tf32": tf32}
    # the launches of this slice's main paths, beside each kernel's earlier ones
    slice_paths = {
        "K1f": {"launches_beam": beam["True"]["counts"]["K1f"],
                "launches_export": exported["True"]["counts"]["K1f"]},
        "K4f": {"launches_beam": beam["bi_grid"]["counts"]["K4f"],
                "launches_export": exported["bi_grid"]["counts"]["K4f"]},
        "K2f": {"launches_session": session["flash"]["counts"]["K2f"],
                "launches_ctc_training": ctc_train["counts"]["K2f"]},
        "K3f": {"launches_session": session["fused"]["counts"]["K3f"],
                "launches_beam_conformer": beam["conformer_fused"]["counts"]["K3f"]},
        "K5f": {"launches_session": {i: session[i]["counts"]["K5f"] for i in ("flash", "fused")},
                "launches_pool": pool["counts"]["K5f"],
                "launches_beam_conformer": beam["conformer_fused"]["counts"]["K5f"],
                "launches_ctc_training": ctc_train["counts"]["K5f"]},
        **{k: {"launches_ctc_training": ctc_train["counts"][k]}
           for k in ("K2b-dq", "K2b-dkv", "K5b")},
    }
    ids = {"lstm_recurrence_fwd": "K1f", "lstm_recurrence_bwd": "K1b",
           "banded_attention_fwd": "K2f", "banded_attention_dq": "K2b-dq",
           "banded_attention_dkv": "K2b-dkv", "fused_attention_fwd": "K3f",
           "bilstm_grid_fwd": "K4f", "bilstm_grid_bwd": "K4b", "layer_norm_fwd": "K5f",
           "layer_norm_bwd": "K5b"}
    # the launches of the MoE, int8 and raw-voltage paths (phases 15-19)
    int8_k = lambda k: {i: int8[i]["counts"][k] for i in ("flash", "fused")}  # noqa: E731
    moe_paths = {
        "K2f": {"launches_moe_serving": moe_serve["flash"]["counts"]["K2f"],
                "launches_moe_training": moe_train["counts"]["K2f"],
                "launches_int8_session": int8_k("K2f"),
                "launches_raw_session": raw_session["counts"]["K2f"]},
        "K3f": {"launches_moe_serving": moe_serve["fused"]["counts"]["K3f"],
                "launches_int8_session": int8_k("K3f")},
        "K5f": {"launches_moe_serving": {i: moe_serve[i]["counts"]["K5f"]
                                         for i in ("flash", "fused")},
                "launches_moe_training": moe_train["counts"]["K5f"],
                "launches_int8_session": int8_k("K5f"),
                "launches_raw_session": raw_session["counts"]["K5f"]},
        **{k: {"launches_moe_training": moe_train["counts"][k]}
           for k in ("K2b-dq", "K2b-dkv", "K5b")},
    }
    # the launches of phase 21's paths: the trainer's tools, conformer export
    tc, an, lz = tools["curriculum"], tools["analysis"], tools["lazy"]
    tools_paths = {
        "K1f": {"launches_curriculum": tc["counts"]["K1f"],
                "launches_recovery": tools["recovery"]["counts"]["K1f"],
                "launches_saliencies": an["sal_counts"]["K1f"],
                "launches_activations": an["act_counts"]["K1f"],
                "launches_lazy_shards": lz["counts"]["K1f"]},
        "K1b": {"launches_curriculum": tc["counts"]["K1b"],
                "launches_curriculum_by_fit": [c["K1b"] for c in tc["fit_counts"]],
                "launches_saliencies": an["sal_counts"]["K1b"],
                "launches_lazy_shards": lz["counts"]["K1b"]},
        "K2f": {"launches_export": {n: cexport[n]["counts"]["K2f"]
                                    for n in ("flash", "moe_capacity")}},
        "K3f": {"launches_export": {n: cexport[n]["counts"]["K3f"] for n in ("fused", "moe")}},
        "K5f": {"launches_export": {n: r["counts"]["K5f"] for n, r in cexport.items()}},
    }
    # the launches of phases 22-25 on every rank of each path (all ten
    # kernels: a 0 says the path does not run it)
    def by_rank(counts_by_rank, k):
        return [c[k] for c in counts_by_rank]

    spc = sp["counts_by_rank"]
    parallel_paths = {k: {
        "launches_dp_training": {
            "conformer_gloo_x2": by_rank(dp["conformer_gloo x2"]["counts_by_rank"], k),
            "bilstm_gloo_x2": by_rank(dp["bilstm_gloo x2"]["counts_by_rank"], k),
            "conformer_nccl_x1": by_rank(dp["conformer_nccl x1"]["counts_by_rank"], k)},
        "launches_sp_encode": {impl: [c[f"encode_{impl}_bf16"][k] for c in spc]
                               for impl in ("flash", "fused")},
        "launches_sp_training": [c["train_bf16"][k] for c in spc],
        "launches_ep_training": {label: by_rank(ep[label]["counts_by_rank"], k)
                                 for label in ("ep2", "ep2_sp2")},
        "launches_demo_twin": twin["counts"][k],
        "launches_decode_quality": quality["counts"][k],
        "launches_tp_pp_by_rank": {name: by_rank(r["counts_by_rank"], k)
                                   for name, r in tpp.items()},
    } for k in WRAPPERS}
    line["parallel"] = {
        "dp": {label: {key: dp[label][key] for key in ("ms", "mfu", "param_err", "loss_err")
                       if key in dp[label]}
               for label in ("conformer_gloo x2", "conformer_nccl x1", "bilstm_gloo x2")},
        "dp_one_process_ms": {w: dp[f"{w}_one_process_ms"] for w in ("conformer", "bilstm")},
        "dp_conformer_one_process_mfu": dp["conformer_one_process_mfu"],
        "sp": {k: sp[k] for k in ("errs", "ms_by_rank", "one_process_ms")},
        "ep": {label: {k: v for k, v in r.items() if k != "counts_by_rank"}
               for label, r in ep.items()},
        "tp_pp": {name: {k: v for k, v in r.items() if k != "counts_by_rank"}
                  for name, r in tpp.items()},
    }
    # the launches of phase 29's paths (all ten kernels: a 0 says the path
    # does not run it)
    sweep_paths = {k: {
        "launches_sweeps": {"perf_vs_training_size_bi_grid": sweeps["perf"]["counts"][k],
                            "grid_search": sweeps["grid"]["counts"][k]},
        "launches_contributions": {m: c[k] for m, c in sweeps["contributions"]["counts"].items()},
    } for k in WRAPPERS}
    line["sweeps"] = {
        "s": sweeps["s"],
        **{name: {key: sweeps[name][key] for key in ("s", "cells", "steps", "encodes", "wers")}
           for name in ("perf", "grid")},
        "grid_best": sweeps["grid"]["best"],
        "contributions": {key: sweeps["contributions"][key]
                          for key in ("s", "positions", "sal_err")}}
    # the launches of phase 30's paths (all ten kernels: a 0 says the path
    # does not run it)
    example_paths = {k: {"launches_examples": {
        "run_mocha_scale": examples["mocha"]["counts"][k],
        **{f"stream_long_recording_{impl}": r["counts"][k]
           for impl, r in examples["stream"].items()},
        "serve_pool": examples["pool"]["counts"][k],
        "raw_voltage_demo_bi_grid": examples["raw"]["counts"][k],
        "moe_expert_parallel_by_rank": by_rank(examples["moe"]["counts_by_rank"], k),
        "migrate_from_reference": examples["migrate"]["counts"][k]}} for k in WRAPPERS}
    line["examples"] = {
        "s": examples["s"],
        "run_mocha_scale": {k: v for k, v in examples["mocha"].items()
                            if k not in ("counts", "bodies")},
        **{name: {k: v for k, v in r.items() if k not in ("counts", "counts_by_rank")}
           for name, r in (("serve_pool", examples["pool"]),
                           ("raw_voltage_demo", examples["raw"]),
                           ("moe_expert_parallel", examples["moe"]),
                           ("migrate_from_reference", examples["migrate"]))},
        "stream_long_recording": {impl: {k: v for k, v in r.items() if k != "counts"}
                                  for impl, r in examples["stream"].items()}}
    line["demo_twin"] = {"wers": twin["wers"], "s": twin["s"],
                         "elec_contribs": twin["elec_contribs"]}
    line["decode_quality"] = {"wers": quality["wers"], "s": quality["s"]}
    for entry in line["kernels"]:
        entry.update(slice_paths.get(ids[entry["name"]], {}))
        entry.update(moe_paths.get(ids[entry["name"]], {}))
        entry.update(tools_paths.get(ids[entry["name"]], {}))
        entry.update(parallel_paths[ids[entry["name"]]])
        entry.update(sweep_paths[ids[entry["name"]]])
        entry.update(example_paths[ids[entry["name"]]])
    line["script_s"] = time.perf_counter() - t_start
    print(f"chip_smoke.py took {line['script_s']:.1f} s")
    print(json.dumps(line))
    print(f"gpu: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
