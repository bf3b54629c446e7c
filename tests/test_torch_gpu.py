"""Tests of the port's CUDA kernels that need an NVIDIA GPU.

They import torch and the port only (no JAX), so they run on a machine
with a card and without the JAX package's test setup:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Without a CUDA device every test here skips.  Tolerances as in
``chip_smoke.py``: f32 rtol 1e-4 / atol 1e-5, bf16 rtol 5e-2 / atol 2e-2.
"""

import pytest
import torch

from ecog2txt_tpu_torch.ops import _build, lstm_kernels

T, B, H = 9, 5, 64
TOL = {
    torch.float32: dict(rtol=1e-4, atol=1e-5),
    torch.bfloat16: dict(rtol=5e-2, atol=2e-2),
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(dtype, reverse_time):
    g = torch.Generator().manual_seed(0)
    xw = torch.randn((T, B, 4 * H), generator=g).to(dtype)
    wh = (torch.randn((H, 4 * H), generator=g) / H ** 0.5).to(dtype)
    lengths = torch.tensor([T, 1, 4, 0, 7], dtype=torch.int32)
    mask = (torch.rand((B, H), generator=g) < 0.5).float() * 2.0
    state = torch.zeros((B, H)) if reverse_time else torch.randn((B, H), generator=g)
    args = (xw, wh, lengths, state, state * 0.5, mask)
    return tuple(a.cuda() for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse_time", [False, True])
def test_kernel_matches_plain_version(dtype, reverse_time):
    _need_cuda()
    args = _inputs(dtype, reverse_time)
    before = lstm_kernels.lstm_recurrence.launches
    got = lstm_kernels.lstm_recurrence(
        *args, reverse_time=reverse_time, return_c_seq=True
    )
    torch.cuda.synchronize()
    assert lstm_kernels.lstm_recurrence.launches == before + 1
    want = lstm_kernels.lstm_recurrence_reference(
        *args, reverse_time=reverse_time, return_c_seq=True
    )
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


@pytest.mark.gpu
def test_cuda_tensor_without_library_raises(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    way to build the library it raises instead of falling back."""
    _need_cuda()
    _build.load_library.cache_clear()
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "_absent")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    before = lstm_kernels.lstm_recurrence.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            lstm_kernels.lstm_recurrence(*_inputs(torch.float32, False))
    finally:
        _build.load_library.cache_clear()
    assert lstm_kernels.lstm_recurrence.launches == before
