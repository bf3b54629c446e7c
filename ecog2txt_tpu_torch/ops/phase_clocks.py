"""Where a block of K3f's tensor-core body spends its time, on the card.

    python -m ecog2txt_tpu_torch.ops.phase_clocks

Builds ``csrc/fused_attention_tc.cu`` once more with ``-DATTN_PHASE_CLOCKS``
(thread 0 of each block writes ``clock64()`` at the phase boundaries marked
in the source; the library the port loads has no stamps), launches it at the
headline conformer shape (B=256, T'=104, D=384, 6 heads, chunk 16, left
context 1, bf16) and at a B=1 request (query blocks of 128 and 32 rows), and
prints the mean cycles of each phase over the blocks beside the CUDA-event
time of K3f (both of its launches) and, from ``torch.profiler``, the
device time of each of the two kernels.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from . import _build
from . import attention_kernels as ak

_STAMPS = 64  # csrc/attention_tc.cuh::kPhaseStamps


def _library() -> ctypes.CDLL:
    source = _build.CSRC_DIR / "fused_attention_tc.cu"
    out = _build.BUILD_DIR / f"libfused_attention_tc_phases-{_build._digest('phases')}.so"
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DATTN_PHASE_CLOCKS", "-o",
                        str(out), str(source)], check=True)
    return ctypes.CDLL(str(out))


def phases(clocks: np.ndarray, tiles: int) -> dict:
    """Mean cycles of each phase over the blocks' (blocks, 64) stamps."""
    c = clocks.astype(np.float64)
    span = lambda a, b: float(np.mean(c[:, b] - c[:, a]))  # noqa: E731
    out = {"set-up": span(0, 1), "first tile landing": span(1, 2),
           "products (each with the next tile's wait and staging)":
               sum(span(2 + t, 3 + t) for t in range(tiles - 1)) + span(1 + tiles, _STAMPS - 6),
           "epilogue": span(_STAMPS - 6, _STAMPS - 5), "rotary": span(_STAMPS - 5, _STAMPS - 4),
           "residuals": span(_STAMPS - 4, _STAMPS - 3),
           "attention pass 1 and the window's average": span(_STAMPS - 3, _STAMPS - 2),
           "attention pass 2 and the output": span(_STAMPS - 2, _STAMPS - 1)}
    out["block"] = span(0, _STAMPS - 1)
    return out


def measure(B: int, T: int, QB: int, D: int = 384, H: int = 6, C: int = 16, L: int = 1,
            seed: int = 0) -> dict:
    """One shape: phase cycles, the launch's time and each kernel's device
    time."""
    lib = _library()
    fn = lib.fused_attention_fwd_tc
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.attn_set_phase_clocks.argtypes = [ctypes.c_void_p]
    Dh, T1 = D // H, -(-T // QB) * QB
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, T1, D), generator=g, device="cuda").to(torch.bfloat16)
    xw = ak._split_rot_weights(torch.randn((D, 3 * D), generator=g, device="cuda") / D ** 0.5,
                               H, torch.bfloat16)
    lng, lnb = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
    freq = ak._rope_freq_tensor(H, D, torch.device("cuda"))
    lengths = torch.full((B,), T, dtype=torch.int32, device="cuda")
    out = torch.empty_like(x)
    lnx = torch.empty_like(x)
    rot = torch.empty((T1 + L * C, D, 2), dtype=torch.bfloat16, device="cuda")
    blocks = T1 // QB * H * B
    clocks = torch.zeros((blocks, _STAMPS), dtype=torch.int64, device="cuda")
    ptrs = [a.data_ptr() if a is not None else None
            for a in (x, xw[0], xw[2], xw[4], lng, lnb, freq, lengths, out, None, None, None,
                      None, lnx, rot)]

    def launch():
        err = fn(*ptrs, B, T1, H, Dh, C, L, T, QB, 0, 0, ak._scale(Dh), 1e-6,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fused_attention_fwd_tc failed with CUDA error {err}")

    lib.attn_set_phase_clocks(clocks.data_ptr())
    launch()
    torch.cuda.synchronize()
    cycles = phases(clocks.cpu().numpy(), -(-D // 64))
    lib.attn_set_phase_clocks(None)
    for _ in range(3):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        launch()
    end.record()
    end.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            launch()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        name = re.search(r"fused_attention_\w+_kernel", ev.key)
        if ev.device_type == DeviceType.CUDA and name:
            kernels[name.group(0)] = kernels.get(name.group(0), 0.0) + (
                ev.self_device_time_total / 1e3 / 5)
    return {"cycles": cycles, "ms": start.elapsed_time(end) / 20, "kernel_ms": kernels,
            "blocks": blocks}


def main() -> None:
    print(f"{torch.cuda.get_device_name(0)}; phase clocks of K3f's tensor-core body (thread 0 "
          "of each block, mean over the blocks)")
    for B, T, QB in ((256, 104, 128), (1, 104, 128), (1, 104, 32)):
        r = measure(B, T, QB)
        print(f"B={B} T'={T} query block {QB} ({r['blocks']} blocks): both launches "
              f"{r['ms']:.4f} ms; device time " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in r["kernel_ms"].items()))
        print("  cycles: " + ", ".join(f"{k} {v:.0f}" for k, v in r["cycles"].items()))


if __name__ == "__main__":
    main()
