"""Drive the PyTorch/CUDA port (``ecog2txt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run (non-zero exit) on any error:

1. environment: the card's name and power limit, CUDA / nvcc / triton
   versions, and the time to build the kernels from ``csrc/``;
2. kernels: every kernel against its plain PyTorch version on the card,
   at the serving shapes (H=400, T'=104, B in {1, 256}), forward and
   reverse time, f32 and bf16, ragged lengths, a mask that is not all
   ones and a nonzero initial state; then CUDA-event timings of the
   kernel, its plain version and a one-call library yardstick, beside
   the least time the card could take (``bound_ms``);
3. serving (the main path): the full-width biLSTM model of the JAX
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
4. the ``kernels`` JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is
present.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ecog2txt_tpu_torch.models.seq2seq import (
    AuxHead,
    Seq2SeqConfig,
    encode,
    init_seq2seq,
)
from ecog2txt_tpu_torch.ops import _build, lstm_kernels
from ecog2txt_tpu_torch.ops.lstm import init_lstm_params
from ecog2txt_tpu_torch.serve import OnlinePredictor, StreamingSession

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


class SmokeFailure(RuntimeError):
    pass


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict):
    """Max abs / rel error; fails unless |got-want| <= atol + rtol|want|."""
    g, w = got.float(), want.float()
    check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    diff = (g - w).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max()) if diff.numel() else 0.0
    ok = bool((diff <= tol["atol"] + tol["rtol"] * w.abs()).all())
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
    t0 = time.perf_counter()
    _build.load_library("lstm_recurrence")
    build_s = time.perf_counter() - t0
    print(f"kernel build: lstm_recurrence {build_s:.2f} s")
    return {"build_s": build_s}


# --------------------------------------------------------------------------
# 2. kernels
# --------------------------------------------------------------------------


def _recurrence_inputs(B, dtype, variant, reverse_time, seed):
    g = torch.Generator().manual_seed(seed)
    p = init_lstm_params(g, IN_DIM, H, device="cuda")
    xs = torch.randn((T_STEPS, B, IN_DIM), generator=g).cuda()
    xw = (xs @ p["wx"] + p["b"]).to(dtype).contiguous()
    wh = p["wh"].to(dtype).contiguous()
    zeros = torch.zeros((B, H), device="cuda")
    if variant == "serving":
        lengths = torch.full((B,), T_STEPS, dtype=torch.int32)
        mask, h0, c0 = torch.ones_like(zeros), zeros, zeros
    else:
        lengths = torch.randint(1, T_STEPS + 1, (B,), generator=g, dtype=torch.int32)
        lengths[0] = T_STEPS // 2 + 1
        mask = (torch.rand((B, H), generator=g) < 0.5).float().cuda() * 2.0
        if reverse_time:  # the reverse-time recurrence takes a zero state
            h0 = c0 = zeros
        else:
            h0 = (torch.randn((B, H), generator=g) * 0.5).cuda()
            c0 = (torch.randn((B, H), generator=g) * 0.5).cuda()
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


def kernel_phase() -> dict:
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timings = {}
    seed = 0
    for B in (1, 256):
        for dtype in (torch.float32, torch.bfloat16):
            for reverse_time in (False, True):
                for variant in ("serving", "ragged_mask_state"):
                    seed += 1
                    args = _recurrence_inputs(B, dtype, variant, reverse_time, seed)
                    with_c = variant != "serving"
                    got = lstm_kernels.lstm_recurrence(
                        *args, reverse_time=reverse_time, return_c_seq=with_c
                    )
                    want = lstm_kernels.lstm_recurrence_reference(
                        *args, reverse_time=reverse_time, return_c_seq=with_c
                    )
                    torch.cuda.synchronize()
                    case = (f"B={B} {str(dtype)[6:]} "
                            f"{'reverse' if reverse_time else 'forward'} {variant}")
                    worst = (0.0, 0.0)
                    for name, g, w in zip(("h_seq", "c_seq", "hT", "cT"), got, want):
                        if w is None:
                            continue
                        a, r = compare(f"{case} {name}", g, w, TOL[dtype])
                        worst = (max(worst[0], a), max(worst[1], r))
                    errs[dtype] = max(errs[dtype], worst[0])
                    print(f"kernel lstm_recurrence_fwd {case}: max abs err "
                          f"{worst[0]:.3e}, max rel err {worst[1]:.3e}")

        # timings at the serving shape: bf16, full lengths, unit mask, zero state
        args = _recurrence_inputs(B, torch.bfloat16, "serving", False, 1000 + B)
        kernel_ms = cuda_ms(lambda: lstm_kernels.lstm_recurrence(*args), reps=20)
        plain_ms = cuda_ms(
            lambda: lstm_kernels.lstm_recurrence_reference(*args), reps=3, warmup=1
        )
        lstm = _library_lstm(args[1])
        with torch.no_grad():
            lib_out, _ = lstm(args[0])
            library_ms = cuda_ms(lambda: lstm(args[0]), reps=20)
        ours = lstm_kernels.lstm_recurrence(*args)[0]
        lib_err = float((lib_out.float() - ours.float()).abs().max())
        bound_ms, bound_by = _bound(B, torch.bfloat16)
        t = {
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if B == 1:
            t["note"] = ("at B=1 the 104-step serial chain, not bytes or "
                         "FLOPs, sets the real floor")
        else:
            sweep = {}
            for rows in lstm_kernels._ROWS_PER_BLOCK:
                sweep[rows] = cuda_ms(
                    lambda: lstm_kernels._launch(*args, False, False, rows), reps=10
                )
            t["rows_per_block_ms"] = sweep
        timings[B] = t
        print(f"timing lstm_recurrence_fwd B={B} T'={T_STEPS} H={H} bf16: "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library (cuDNN nn.LSTM) {library_ms:.4f} ms "
              f"[max abs diff to the kernel {lib_err:.3e}], "
              f"bound {bound_ms:.4f} ms ({bound_by})"
              + (f", rows/block sweep {t['rows_per_block_ms']}" if B > 1 else ""))
    return {"errs": errs, "timings": timings}


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
    lstm_kernels.lstm_recurrence.launches = 0
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
    launches = lstm_kernels.lstm_recurrence.launches
    # ------------------------------------------------------------------
    expected = calls * ENCODES_PER_CALL * LAUNCHES_PER_ENCODE
    check(launches == expected,
          f"recurrence kernel launched {launches} times in {calls} predictor "
          f"calls; expected {expected}")
    check(np.array_equal(streamed["tokens"], single_out[1]["tokens"]),
          "streaming: tokens differ from the whole utterance")
    check(np.allclose(streamed["probabilities"], single_out[1]["probabilities"],
                      rtol=1e-6, atol=1e-7),
          "streaming: probabilities differ from the whole utterance")
    check(streamed["sequences"] == single_out[1]["sequences"],
          "streaming: sequences differ from the whole utterance")
    print(f"serving: {calls} predictor calls, {launches} recurrence launches "
          f"({LAUNCHES_PER_ENCODE} per encode)")
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
    print(f"f32 encoder, kernel vs plain path: max abs err {f32_err:.3e}; "
          "greedy tokens identical")
    profile_requests(predictor, {"B=1": singles[0], "B=256": batch})
    return {
        "launches": launches, "calls": calls, "latency_s": latencies,
        "batch_s": batch_s, "enc_err_bf16": enc_err, "enc_err_f32": f32_err,
    }


def _category(kernel: str) -> str:
    if "lstm_recurrence_fwd" in kernel:
        return "recurrence kernel"
    if "Memcpy" in kernel or "Memset" in kernel:
        return "memcpy"
    if any(k in kernel.lower() for k in ("gemm", "xmma", "cutlass", "cublas")):
        return "GEMM"
    return "other kernels"


def profile_requests(predictor, requests: dict) -> None:
    """Where a request's device time goes: one warmed-up predictor call
    under ``torch.profiler``, device time summed by kernel category,
    beside the call's wall time (the profiler adds host overhead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, x in requests.items():
        predictor(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            predictor(x)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_cat: dict[str, float] = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                cat = _category(ev.key)
                by_cat[cat] = by_cat.get(cat, 0.0) + ev.self_device_time_total / 1e3
        busy = sum(by_cat.values())
        check(by_cat.get("recurrence kernel", 0.0) > 0.0,
              f"profile {name}: no recurrence kernel time in the trace")
        print(f"profile {name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall_ms:.1f} %): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in
                          sorted(by_cat.items(), key=lambda kv: -kv[1])))


# --------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a GPU",
              file=sys.stderr)
        return 2
    env = environment()
    kern = kernel_phase()
    serve = serving_phase()
    t256, t1 = kern["timings"][256], kern["timings"][1]
    line = {"kernels": [{
        "name": "lstm_recurrence_fwd",
        "route": "cuda",
        "source": "ecog2txt_tpu_torch/csrc/lstm_recurrence.cu",
        "replaces": "ecog2txt_tpu/ops/pallas_lstm.py:215",
        "launches": serve["launches"],
        "launches_per_request": ENCODES_PER_CALL * LAUNCHES_PER_ENCODE,
        "max_abs_err": max(kern["errs"].values()),
        "max_abs_err_f32": kern["errs"][torch.float32],
        "max_abs_err_bf16": kern["errs"][torch.bfloat16],
        "shape": f"T'={T_STEPS} B=256 H={H} bf16",
        "ms": t256["ms"], "plain_ms": t256["plain_ms"],
        "bound_ms": t256["bound_ms"], "bound_by": t256["bound_by"],
        "library_ms": t256["library_ms"],
        "rows_per_block_ms": t256["rows_per_block_ms"],
        "build_s": env["build_s"],
        "at_batch_1": t1,
    }]}
    print(json.dumps(line))
    print(f"gpu: {gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
