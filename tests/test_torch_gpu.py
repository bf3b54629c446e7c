"""Tests of the port's CUDA kernels (K1f, K1b, K2f, K2b-dq, K2b-dkv, K3f,
K4f, K4b, K5f, K5b) that need an NVIDIA GPU.

They import torch and the port only (no JAX), so they run on a machine
with a card and without the JAX package's test setup:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Without a CUDA device every test here skips.  Tolerances as in
``chip_smoke.py``: f32 rtol 1e-4 / atol 1e-5, bf16 rtol 5e-2 / atol 2e-2.
"""

import dataclasses

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


def _bwd_inputs(dtype, T, B, H, seed=1):
    """Adjoint inputs: ragged lengths with a zero, a 0/2 mask, nonzero
    upstream gradients."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    lengths = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0] = 0
    mask = (torch.rand((B, H), generator=g) < 0.5).float() * 2.0
    args = (
        rand(T, B, 4 * H).to(dtype), (rand(H, 4 * H) / H ** 0.5).to(dtype),
        rand(T, B, H).to(dtype), rand(T, B, H).to(dtype),
        rand(T, B, H).to(dtype), lengths, mask, rand(T, B, H).to(dtype),
        rand(B, H), rand(B, H),
    )
    return tuple(a.cuda() for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse_time", [False, True])
@pytest.mark.parametrize("shape", ["small", "training"])
def test_bwd_kernel_matches_plain_version(dtype, reverse_time, shape):
    _need_cuda()
    dims = (T, B, H) if shape == "small" else (104, 16, 400)
    args = _bwd_inputs(dtype, *dims)
    before = lstm_kernels.lstm_recurrence_bwd.launches
    got = lstm_kernels.lstm_recurrence_bwd(*args, reverse_time=reverse_time)
    torch.cuda.synchronize()
    assert lstm_kernels.lstm_recurrence_bwd.launches == before + 1
    want = lstm_kernels.lstm_recurrence_bwd_reference(
        *args, reverse_time=reverse_time
    )
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("reverse_time", [False, True])
def test_function_gradients_match_plain_autograd(reverse_time):
    """Forward K1f + backward K1b against autograd through the plain
    forward step loop, at f32."""
    _need_cuda()
    xw, wh, lengths, h0, c0, mask = _inputs(torch.float32, reverse_time)
    w_out = torch.randn((H,), generator=torch.Generator().manual_seed(2)).cuda()

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (xw, wh, h0, c0)]
        out, hT, cT = fn(*leaves)
        loss = (out * w_out).sum() + 2.0 * hT.sum() + 0.5 * (cT ** 2).sum()
        loss.backward()
        return [a.grad for a in leaves]

    f0, b0 = lstm_kernels.lstm_recurrence.launches, lstm_kernels.lstm_recurrence_bwd.launches
    got = grads(lambda x, w, h, c: lstm_kernels.fused_lstm_recurrence(
        x, w, lengths, h, c, mask, reverse_time))
    assert lstm_kernels.lstm_recurrence.launches == f0 + 1
    assert lstm_kernels.lstm_recurrence_bwd.launches == b0 + 1

    def plain(x, w, h, c):
        h_seq, _, hT, cT = lstm_kernels.lstm_recurrence_reference(
            x, w, lengths, h, c, mask, reverse_time)
        return h_seq, hT, cT

    want = grads(plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL[torch.float32])


@pytest.mark.gpu
def test_training_step_launches_the_kernels():
    """One step of the segment runner on the card (bf16, dropout on):
    each biLSTM layer launches K1f and K1b once per direction, and the
    loss is finite."""
    _need_cuda()
    import numpy as np

    from ecog2txt_tpu_torch.convert import tree_map
    from ecog2txt_tpu_torch.models.seq2seq import AuxHead, Seq2SeqConfig, init_seq2seq
    from ecog2txt_tpu_torch.train import TrainState, make_optimizer, make_segment_runner

    cfg = Seq2SeqConfig(
        vocab_size=30, in_channels=7, conv_sizes=(16,), decimation_factor=4,
        rnn_sizes=(H, H), aux_proj_sizes=(8,),
        aux_heads=(AuxHead("aux", "categorical", 5),), dec_embedding_size=8,
        dec_rnn_sizes=(2 * H,), max_dec_len=6, compute_dtype=torch.bfloat16,
        use_pallas_lstm=True,
    )
    params = init_seq2seq(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    N, Traw = 8, 48
    dec = torch.randint(3, 30, (1, N, 6), generator=g, dtype=torch.int32)
    dec[..., -1] = 1
    data = {
        "encoder_inputs": torch.randn((1, N, Traw, 7), generator=g).bfloat16(),
        "encoder_lengths": torch.randint(12, Traw + 1, (1, N), generator=g,
                                         dtype=torch.int32),
        "decoder_targets": dec,
        "decoder_lengths": torch.full((1, N), 6, dtype=torch.int32),
        "aux": torch.randint(0, 5, (1, N, Traw), generator=g, dtype=torch.int32),
    }
    data = {k: v.cuda() for k, v in data.items()}
    state = TrainState(params, tree_map(lambda t: t.detach().clone(), params),
                       make_optimizer(params, 1e-3), 0)
    runner = make_segment_runner(cfg, {"aux": 1.0}, 0.99)
    f0, b0 = lstm_kernels.lstm_recurrence.launches, lstm_kernels.lstm_recurrence_bwd.launches
    state, metrics = runner(state, data, np.zeros(1, np.int32),
                            np.arange(4, dtype=np.int32)[None],
                            torch.Generator(device="cuda").manual_seed(0), 1)
    assert np.isfinite(float(metrics["loss_total"]))
    assert lstm_kernels.lstm_recurrence.launches == f0 + 4
    assert lstm_kernels.lstm_recurrence_bwd.launches == b0 + 4


# --------------------------------------------------------------------------
# the banded-attention kernels (K2f, K2b-dq, K2b-dkv, K3f)
# --------------------------------------------------------------------------


def _attention_inputs(dtype, B=2, T=100, H=2, Dh=16, C=8, L=2, offset=-16, seed=3):
    """q, k, v, g, x (B, T1, D) with T1 a multiple of QB=32 (four query
    blocks, a trailing pad), ragged lengths at a negative offset, the
    K3f weights; the static arguments of the wrappers."""
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    QB = ak._pick_query_rows(C, L, 32)
    T1 = -(-T // QB) * QB
    D = H * Dh
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    seqs = [rand(B, T1, D).to(dtype).cuda() for _ in range(5)]
    lengths = torch.tensor([T + offset, T + offset - 13], dtype=torch.int32).cuda()
    weights = ak._split_rot_weights((rand(D, 3 * D) / D ** 0.5).cuda(), H, dtype)
    ln = ((1 + 0.1 * rand(D)).cuda(), (0.1 * rand(D)).cuda())
    pos = torch.arange(T1).cuda() + offset
    valid = ((torch.arange(T1).cuda()[None] < T) & (pos[None] >= 0)
             & (pos[None] < lengths[:, None]))[..., None]
    return seqs, weights, ln, valid, (offset, lengths, C, L, T, QB, H)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_match_plain_versions(dtype):
    """Each of the four kernels launches once and matches its plain
    version (forward outputs on valid rows, backward outputs on every
    row)."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    (q, k, v, gout, x), xw, (ln_g, ln_b), valid, args = _attention_inputs(dtype)
    H = args[-1]
    rows = lambda a: torch.where(valid, a.float(), 0.0)  # noqa: E731
    wrappers = (ak.banded_attention_fwd, ak.banded_attention_dq,
                ak.banded_attention_dkv, ak.fused_attention_fwd)
    before = [w.launches for w in wrappers]
    out, lse = ak.banded_attention_fwd(q, k, v, *args)
    r_out, r_lse = ak.banded_attention_fwd_reference(q, k, v, *args)
    bwd = (q, k, v, gout, r_lse, ak._delta(gout, r_out, H), *args)
    dq = ak.banded_attention_dq(*bwd)
    dk, dv = ak.banded_attention_dkv(*bwd)
    fused = ak.fused_attention_fwd(x, xw, ln_g, ln_b, *args, True)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    torch.testing.assert_close(rows(out), rows(r_out), **TOL[dtype])
    torch.testing.assert_close(rows(lse), rows(r_lse), **TOL[torch.float32])
    torch.testing.assert_close(dq.float(), ak.banded_attention_dq_reference(*bwd).float(),
                               **TOL[dtype])
    for got, want in zip((dk, dv), ak.banded_attention_dkv_reference(*bwd)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    want = ak.fused_attention_fwd_reference(x, xw, ln_g, ln_b, *args, True)
    for name, got, w in zip(("out", "q", "k", "v", "lse"), fused, want):
        if name in ("out", "lse"):
            got, w = rows(got), rows(w)
        tol = TOL[torch.float32] if name == "lse" and dtype == torch.float32 else TOL[dtype]
        torch.testing.assert_close(got.float(), w.float(), **tol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [48, 96])
def test_banded_kernels_take_a_head_dim_that_does_not_divide_256(dtype, Dh):
    """K2f, K2b-dq, K2b-dkv and K3f at a head dim that does not divide the
    256 threads of a block match their plain versions (K3f's spare
    threads idle in its projections)."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    (q, k, v, gout, x), xw, (ln_g, ln_b), valid, args = _attention_inputs(dtype, Dh=Dh)
    H = args[-1]
    rows = lambda a: torch.where(valid, a.float(), 0.0)  # noqa: E731
    out, lse = ak.banded_attention_fwd(q, k, v, *args)
    r_out, r_lse = ak.banded_attention_fwd_reference(q, k, v, *args)
    torch.testing.assert_close(rows(out), rows(r_out), **TOL[dtype])
    torch.testing.assert_close(rows(lse), rows(r_lse), **TOL[torch.float32])
    bwd = (q, k, v, gout, r_lse, ak._delta(gout, r_out, H), *args)
    torch.testing.assert_close(ak.banded_attention_dq(*bwd).float(),
                               ak.banded_attention_dq_reference(*bwd).float(), **TOL[dtype])
    for got, want in zip(ak.banded_attention_dkv(*bwd), ak.banded_attention_dkv_reference(*bwd)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    before = ak.fused_attention_fwd.launches
    fused = ak.fused_attention_fwd(x, xw, ln_g, ln_b, *args, True)
    torch.cuda.synchronize()
    assert ak.fused_attention_fwd.launches == before + 1
    want = ak.fused_attention_fwd_reference(x, xw, ln_g, ln_b, *args, True)
    for name, got, w in zip(("out", "q", "k", "v", "lse"), fused, want):
        if name in ("out", "lse"):
            got, w = rows(got), rows(w)
        tol = TOL[torch.float32] if name == "lse" and dtype == torch.float32 else TOL[dtype]
        torch.testing.assert_close(got.float(), w.float(), **tol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [288, 384, 454, 512])
def test_fused_kernel_matches_plain_version_above_head_dim_256(dtype, Dh):
    """K3f at a head dim above 256 (one head: model width 288 to 512):
    its projections take two head columns a thread, at the largest query
    block that fits shared memory (16 rows at chunk 16 from head dim 384;
    at 512 with 16-column streamed tiles), and it matches its plain
    version."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    C, L = 16, 1
    QB = ak.plan_fused_query_rows(128, C, L, Dh, ak._smem_limit(torch.device("cuda")))
    g = torch.Generator().manual_seed(Dh)
    B, T = 2, 100
    T1 = -(-T // QB) * QB
    x = torch.randn((B, T1, Dh), generator=g).to(dtype).cuda()
    xw = ak._split_rot_weights((torch.randn((Dh, 3 * Dh), generator=g) / Dh ** 0.5).cuda(),
                               1, dtype)
    ln_g, ln_b = (1 + 0.1 * torch.randn((Dh,), generator=g)).cuda(), torch.zeros(Dh).cuda()
    lengths = torch.tensor([T, 61], dtype=torch.int32).cuda()
    valid = (torch.arange(T1).cuda()[None] < lengths[:, None])[..., None]
    args = (0, lengths, C, L, T, QB, 1)
    before = ak.fused_attention_fwd.launches
    got = ak.fused_attention_fwd(x, xw, ln_g, ln_b, *args, True)
    torch.cuda.synchronize()
    assert ak.fused_attention_fwd.launches == before + 1
    want = ak.fused_attention_fwd_reference(x, xw, ln_g, ln_b, *args, True)
    rows = lambda a: torch.where(valid, a.float(), 0.0)  # noqa: E731
    for name, a, w in zip(("out", "q", "k", "v", "lse"), got, want):
        if name in ("out", "lse"):
            a, w = rows(a), rows(w)
        tol = TOL[torch.float32] if name == "lse" and dtype == torch.float32 else TOL[dtype]
        torch.testing.assert_close(a.float(), w.float(), **tol, msg=name)


@pytest.mark.gpu
def test_fused_attention_layer_fits_a_wide_head():
    """At head dim 128 the default ~128-row query block would not fit K3f's
    shared memory; on the card the layer takes a smaller block and its
    output on valid rows and its gradients match the plain path on the CPU
    (default block), f32, held normwise (weight gradients sum B·T products
    in another order).  Rows past a sequence's length whose band holds no
    valid key are a uniform average over the block's window, so they
    depend on the block and are not compared."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    B, T, D, H, C, L = 2, 100, 256, 2, 16, 1
    g = torch.Generator().manual_seed(11)
    leaves = [torch.randn((D, 3 * D), generator=g) / D ** 0.5,
              1 + 0.1 * torch.randn((D,), generator=g), 0.1 * torch.randn((D,), generator=g),
              torch.randn((B, T, D), generator=g)]
    lengths = torch.tensor([T, 77], dtype=torch.int32)
    valid = torch.arange(T)[None, :, None] < lengths[:, None, None]
    cot = torch.randn((B, T, D), generator=g) * valid
    assert ak.plan_fused_query_rows(128, C, L, D // H, ak._smem_limit(torch.device("cuda"))) < 128

    def run(device):
        ls = [a.to(device).requires_grad_() for a in leaves]
        out = ak.fused_attention_layer(*ls, 0, lengths.to(device), chunk_size=C,
                                       left_context=L, num_heads=H)
        (out * cot.to(device)).sum().backward()
        return [out.detach().cpu() * valid] + [a.grad.cpu() for a in ls]

    before = ak.fused_attention_fwd.launches
    got = run("cuda")
    assert ak.fused_attention_fwd.launches == before + 1
    for a, b in zip(got, run("cpu")):
        assert float((a - b).abs().max()) <= float(1e-5 + 1e-4 * b.abs().max())


@pytest.mark.gpu
def test_attention_functions_gradients_match_plain_autograd():
    """BandedAttention (K2f + K2b) and FusedAttentionLayer (K3f + K2b +
    plain products) against autograd through the plain forwards, f32;
    held normwise (weight gradients sum B·T products in another order).
    The f32 parameters' gradients stay f32."""
    _need_cuda()
    import torch.nn.functional as F

    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    (q, k, v, _, x), _, (ln_g, ln_b), valid, args = _attention_inputs(torch.float32)
    offset, lengths, C, L, T, QB, H = args
    B, T1, D = q.shape
    g = torch.Generator().manual_seed(5)
    cot = torch.where(valid[:, :T], torch.randn((B, T, D), generator=g).cuda(), 0.0)
    wqkv = (torch.randn((D, 3 * D), generator=g) / D ** 0.5).cuda()

    def grads(fn, leaves):
        leaves = [a.detach().clone().requires_grad_() for a in leaves]
        (fn(*leaves) * cot).sum().backward()
        return [a.grad for a in leaves]

    def close(got, want):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            bound = 1e-5 + 1e-4 * b.abs().max()
            assert float((a - b).abs().max()) <= float(bound)

    heads = lambda a: a[:, :T].reshape(B, T, H, D // H)  # noqa: E731
    pad = lambda a: F.pad(a.reshape(B, T, D), (0, 0, 0, T1 - T))  # noqa: E731
    kw = dict(chunk_size=C, left_context=L, query_rows=QB)
    close(grads(lambda *a: ak.banded_flash_attention(*a, offset, lengths, **kw).reshape(B, T, D),
                [heads(q), heads(k), heads(v)]),
          grads(lambda *a: ak.banded_attention_fwd_reference(
              *(pad(t) for t in a), *args)[0][:, :T], [heads(q), heads(k), heads(v)]))
    leaves = [wqkv, ln_g, ln_b, x[:, :T]]
    close(grads(lambda w, gg, bb, xx: ak.fused_attention_layer(
              w, gg, bb, xx, offset, lengths, num_heads=H, **kw), leaves),
          grads(lambda w, gg, bb, xx: ak.fused_attention_fwd_reference(
              pad(xx), ak._split_rot_weights(w, H, xx.dtype), gg, bb, *args, False
          )[0][:, :T], leaves))


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["flash", "fused"])
def test_conformer_training_step_launches_the_kernels(impl):
    """One segment-runner step of a small conformer seq2seq on the card
    (bf16, dropout on): each block launches its forward kernel and both
    backward kernels once, and the loss is finite."""
    _need_cuda()
    import numpy as np

    from ecog2txt_tpu_torch.convert import tree_map
    from ecog2txt_tpu_torch.models.conformer import ConformerConfig
    from ecog2txt_tpu_torch.models.seq2seq import AuxHead, Seq2SeqConfig, init_seq2seq
    from ecog2txt_tpu_torch.ops import attention_kernels as ak
    from ecog2txt_tpu_torch.train import TrainState, make_optimizer, make_segment_runner

    cfg = Seq2SeqConfig(
        vocab_size=30, in_channels=7, conv_sizes=(16,), decimation_factor=4,
        aux_proj_sizes=(8,), aux_heads=(AuxHead("aux", "categorical", 5),),
        dec_embedding_size=8, dec_rnn_sizes=(32,), max_dec_len=6,
        compute_dtype=torch.bfloat16, encoder_type="conformer",
        conformer=ConformerConfig(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64,
                                  conv_kernel=4, chunk_size=4, attention_impl=impl),
    )
    params = init_seq2seq(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    N, Traw = 8, 48
    dec = torch.randint(3, 30, (1, N, 6), generator=g, dtype=torch.int32)
    dec[..., -1] = 1
    data = {
        "encoder_inputs": torch.randn((1, N, Traw, 7), generator=g).bfloat16(),
        "encoder_lengths": torch.randint(12, Traw + 1, (1, N), generator=g,
                                         dtype=torch.int32),
        "decoder_targets": dec,
        "decoder_lengths": torch.full((1, N), 6, dtype=torch.int32),
        "aux": torch.randint(0, 5, (1, N, Traw), generator=g, dtype=torch.int32),
    }
    data = {k: v.cuda() for k, v in data.items()}
    state = TrainState(params, tree_map(lambda t: t.detach().clone(), params),
                       make_optimizer(params, 1e-3), 0)
    runner = make_segment_runner(cfg, {"aux": 1.0}, 0.99)
    wrappers = {"K2f": ak.banded_attention_fwd, "K3f": ak.fused_attention_fwd,
                "dq": ak.banded_attention_dq, "dkv": ak.banded_attention_dkv}
    before = {k: w.launches for k, w in wrappers.items()}
    state, metrics = runner(state, data, np.zeros(1, np.int32),
                            np.arange(4, dtype=np.int32)[None],
                            torch.Generator(device="cuda").manual_seed(0), 1)
    assert np.isfinite(float(metrics["loss_total"]))
    fwd = "K2f" if impl == "flash" else "K3f"
    want = {k: 2 if k in (fwd, "dq", "dkv") else 0 for k in wrappers}
    assert {k: w.launches - before[k] for k, w in wrappers.items()} == want


# --------------------------------------------------------------------------
# the redesigned bodies: K2f on the tensor cores, K1b on a cluster
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize(
    "Dh, C, L, QB, offset",
    [(16, 4, 1, 128, 0), (48, 8, 2, 32, -16), (96, 8, 1, 40, 0),
     (64, 16, 1, 48, -64), (64, 16, 1, 48, 256)],
)
def test_k2f_tensor_core_body_matches_plain_version(Dh, C, L, QB, offset):
    """The bf16 body of K2f at padded shapes (head dims 16, 48 and 96; query
    blocks of 32, 40 and 48 rows; offsets -64 and 256), ragged lengths:
    every row, including rows with no valid key (before the sequence at
    offset -64, past its end), matches the plain version, out within the
    bf16 tolerance and lse within f32's."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    H, B, T = 2, 3, 100
    T1 = -(-T // QB) * QB
    g = torch.Generator().manual_seed(Dh + QB)
    q, k, v = (torch.randn((B, T1, H * Dh), generator=g).bfloat16().cuda() for _ in range(3))
    lengths = torch.tensor([T + offset, T + offset - 13, offset + 3], dtype=torch.int32).cuda()
    args = (offset, lengths, C, L, T, QB, H)
    before = dict(ak.banded_attention_fwd.launches_by_body)
    out, lse = ak.banded_attention_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    assert ak.banded_attention_fwd.launches_by_body["tensor_core"] == before["tensor_core"] + 1
    r_out, r_lse = ak.banded_attention_fwd_reference(q, k, v, *args)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(out.float(), r_out.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, r_lse, **TOL[torch.float32])


def _cluster_case(B, H, T, reverse_time, seed):
    """K1b inputs from a real forward pass (the plain recurrence), ragged
    lengths with a zero, a 0/2 mask, nonzero upstream gradients, bf16."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    xw = rand(T, B, 4 * H).bfloat16().cuda()
    wh = (rand(H, 4 * H) / H ** 0.5).bfloat16().cuda()
    lengths = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0] = T if B == 1 else 0
    lengths = lengths.cuda()
    mask = ((torch.rand((B, H), generator=g) < 0.5).float() * 2.0).cuda()
    zeros = torch.zeros((B, H), device="cuda")
    h_seq, c_seq, _, _ = lstm_kernels.lstm_recurrence_reference(
        xw, wh, lengths, zeros, zeros, mask, reverse_time, return_c_seq=True)
    hprev = lstm_kernels._shifted(h_seq, zeros, reverse_time)
    cprev = lstm_kernels._shifted(c_seq, zeros, reverse_time)
    return (xw, wh, hprev, cprev, c_seq, lengths, mask, rand(T, B, H).bfloat16().cuda(),
            rand(B, H).cuda(), rand(B, H).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("reverse_time", [False, True])
@pytest.mark.parametrize("H", [64, 100, 400])
@pytest.mark.parametrize("B", [1, 17, 256])
def test_k1b_cluster_body_matches_plain_version(B, H, reverse_time):
    """The bf16 body of K1b (a cluster of CTAs holding wh in shared memory)
    against its plain version, padded B (1, 17) and H (100), both time
    directions; two launches on the same inputs are bit-identical (the
    partials are summed in a fixed rank order, no atomics)."""
    _need_cuda()
    args = _cluster_case(B, H, 24, reverse_time, seed=B * 1000 + H)
    before = dict(lstm_kernels.lstm_recurrence_bwd.launches_by_body)
    got = lstm_kernels.lstm_recurrence_bwd(*args, reverse_time=reverse_time)
    again = lstm_kernels.lstm_recurrence_bwd(*args, reverse_time=reverse_time)
    torch.cuda.synchronize()
    assert lstm_kernels.lstm_recurrence_bwd.launches_by_body["cluster"] == before["cluster"] + 2
    want = lstm_kernels.lstm_recurrence_bwd_reference(*args, reverse_time=reverse_time)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("reverse_time", [False, True])
@pytest.mark.parametrize("H, cs", [(400, 8), (100, 2), (100, 4), (64, 1), (64, 2)])
def test_k1b_cluster_sizes_match_plain_version(H, cs, reverse_time):
    """The cluster body at cluster sizes the planner may pick, and at more
    CTAs than it picks (100 at 4, 64 at 2), at B=40 (the last cluster
    padded), against the plain version; bit-identical on repeat."""
    _need_cuda()
    args = _cluster_case(40, H, 24, reverse_time, seed=H + cs)
    got = lstm_kernels._launch_bwd_cluster(*args, reverse_time, cs)
    again = lstm_kernels._launch_bwd_cluster(*args, reverse_time, cs)
    torch.cuda.synchronize()
    want = lstm_kernels.lstm_recurrence_bwd_reference(*args, reverse_time=reverse_time)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), **TOL[torch.bfloat16])


def _fwd_cluster_case(B, H, T, reverse_time, seed):
    """K1f inputs in bf16: ragged lengths with a zero (full at B=1), a 0/2
    mask, a nonzero initial state in forward time (zero in reverse)."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    lengths = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0] = T if B == 1 else 0
    mask = (torch.rand((B, H), generator=g) < 0.5).float() * 2.0
    state = torch.zeros((B, H)) if reverse_time else rand(B, H) * 0.5
    args = (rand(T, B, 4 * H).bfloat16(), (rand(H, 4 * H) / H ** 0.5).bfloat16(), lengths,
            state, state * 0.5, mask)
    return tuple(a.cuda() for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("reverse_time", [False, True])
@pytest.mark.parametrize("H", [64, 100, 400])
@pytest.mark.parametrize("B", [1, 17, 256])
def test_k1f_cluster_body_matches_plain_version(B, H, reverse_time):
    """The bf16 body of K1f (a cluster of CTAs holding wh in shared memory,
    h all-gathered through distributed shared memory) against its plain
    version, padded B (1, 17) and H (100), both time directions; two
    launches on the same inputs are bit-identical."""
    _need_cuda()
    args = _fwd_cluster_case(B, H, 24, reverse_time, seed=B * 1000 + H)
    before = dict(lstm_kernels.lstm_recurrence.launches_by_body)
    got = lstm_kernels.lstm_recurrence(*args, reverse_time=reverse_time, return_c_seq=True)
    again = lstm_kernels.lstm_recurrence(*args, reverse_time=reverse_time, return_c_seq=True)
    torch.cuda.synchronize()
    assert lstm_kernels.lstm_recurrence.launches_by_body["cluster"] == before["cluster"] + 2
    want = lstm_kernels.lstm_recurrence_reference(*args, reverse_time, True)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("reverse_time", [False, True])
@pytest.mark.parametrize("H, cs, rows", [(400, 8, 16), (400, 8, 32), (100, 2, 16),
                                         (100, 4, 32), (100, 8, 16), (64, 1, 16), (64, 2, 32),
                                         (64, 8, 16)])
def test_k1f_cluster_shapes_match_plain_version(H, cs, rows, reverse_time):
    """The forward cluster body at every cluster size the planner may pick
    (1 to 8 CTAs) and both rows a cluster, at B=40 (the last cluster
    padded), against the plain version; a row's outputs do not depend on
    the rows a cluster (16 or 32) bit for bit."""
    _need_cuda()
    args = _fwd_cluster_case(40, H, 24, reverse_time, seed=H + cs)
    got = lstm_kernels._launch_cluster(*args, reverse_time, True, cs, rows)
    other = lstm_kernels._launch_cluster(*args, reverse_time, True, cs, 16 if rows == 32 else 32)
    torch.cuda.synchronize()
    want = lstm_kernels.lstm_recurrence_reference(*args, reverse_time, True)
    for a, b, w in zip(got, other, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 17, 256])
def test_k4f_cluster_body_equals_two_k1f_launches(B):
    """K4f's bf16 body (K1f's cluster body with a direction axis) matches
    its plain version and equals two K1f cluster launches bit for bit, at
    B=256 although the two plan different cluster sizes (K4f 2 CTAs, K1f
    4): a unit's product is summed in one order whichever CTA owns it."""
    _need_cuda()
    Hw = 100
    f = _fwd_cluster_case(B, Hw, 24, True, seed=B)
    b = _fwd_cluster_case(B, Hw, 24, True, seed=B + 1)
    args = (f[0], b[0], f[1], b[1], f[2], f[5], b[5])
    before = dict(lstm_kernels.bilstm_grid_fwd.launches_by_body)
    got = lstm_kernels.bilstm_grid_fwd(*args)
    torch.cuda.synchronize()
    assert lstm_kernels.bilstm_grid_fwd.launches_by_body["cluster"] == before["cluster"] + 1
    want = lstm_kernels.bilstm_grid_fwd_reference(*args)
    zeros = torch.zeros((B, Hw), device="cuda")
    hf, cf, hTf, cTf = lstm_kernels.lstm_recurrence(f[0], f[1], f[2], zeros, zeros, f[5],
                                                    False, True)
    hb, cb, hTb, cTb = lstm_kernels.lstm_recurrence(b[0], b[1], f[2], zeros, zeros, b[5],
                                                    True, True)
    two = (hf, hb, cf, cb, torch.stack([hTf, hTb]), torch.stack([cTf, cTb]))
    for g, t, w in zip(got, two, want):
        assert torch.equal(g, t)
        torch.testing.assert_close(g.float(), w.float(), **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [False, True])
def test_cluster_functions_match_their_plain_versions(grid):
    """``LSTMRecurrence`` (K1f + K1b) and ``BiLSTMGrid`` (K4f + K4b) in
    bf16, where both kernels run their cluster bodies, against the same
    Functions on CPU tensors (the plain versions, the same rounding
    points): outputs and the gradients of xw elementwise, the recurrent
    weights' f32 gradients normwise (sums of T'·B products)."""
    _need_cuda()
    Bc, Hc, Tc = 17, 100, 24
    f = _fwd_cluster_case(Bc, Hc, Tc, True, seed=5)
    b = _fwd_cluster_case(Bc, Hc, Tc, True, seed=6)
    w_out = torch.randn((2 * Hc if grid else Hc,), generator=torch.Generator().manual_seed(3))

    def run(device):
        leaves = [a.detach().to(device).requires_grad_() for a in
                  ((f[0], b[0], f[1].float(), b[1].float()) if grid else (f[0], f[1].float()))]
        lengths, mf, mb = f[2].to(device), f[5].to(device), b[5].to(device)
        if grid:
            out, hT, cT = lstm_kernels.fused_bilstm_grid(*leaves, lengths, mf, mb)
        else:
            zeros = torch.zeros((Bc, Hc), device=device)
            out, hT, cT = lstm_kernels.fused_lstm_recurrence(leaves[0], leaves[1], lengths,
                                                             zeros, zeros, mf, True)
        loss = (out.float() * w_out.to(device)).sum() + 2.0 * hT.sum() + 0.5 * (cT ** 2).sum()
        loss.backward()
        return [out.detach().cpu(), *(a.grad.cpu() for a in leaves)]

    names = ("K4f", "K4b") if grid else ("K1f", "K1b")
    wrappers = ((lstm_kernels.bilstm_grid_fwd, lstm_kernels.bilstm_grid_bwd) if grid else
                (lstm_kernels.lstm_recurrence, lstm_kernels.lstm_recurrence_bwd))
    before = [dict(w.launches_by_body) for w in wrappers]
    got = run("cuda")
    for name, w, b0 in zip(names, wrappers, before):
        assert w.launches_by_body == {**b0, "cluster": b0["cluster"] + 1}, name
    want = run("cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bfloat16 or i == 0:
            torch.testing.assert_close(g.float(), w.float(), **TOL[torch.bfloat16])
        else:  # an f32 weight gradient
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, w, rtol=0.0, atol=5e-2 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_kernels_refuse_a_block_beyond_shared_memory(dtype):
    """At head dim 256 (one head: ``model_dim=256, num_heads=1``)
    ``banded_flash_attention`` plans a query block that fits (80 rows f32,
    96 bf16 on the H100): K2f, K2b-dq and K2b-dkv launch in the dtype's
    bodies and match their plain versions at that block, forward and
    backward.  An explicit 128-row f32 block, whose CUDA-core window does
    not fit shared memory, is still refused with ValueError (no number, no
    launch)."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    B, T, Dh, C, L = 2, 100, 256, 16, 1
    QB = ak.plan_banded_query_rows(dtype, 128, C, L, Dh, ak._smem_limit("cuda"))
    assert QB < 128 and QB % 16 == 0
    T1 = -(-T // QB) * QB
    g = torch.Generator().manual_seed(9)
    q, k, v, cot = (torch.randn((B, T, 1, Dh), generator=g).to(dtype).cuda() for _ in range(4))
    lengths = torch.tensor([T, 61], dtype=torch.int32).cuda()
    body = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    wrappers = (ak.banded_attention_fwd, ak.banded_attention_dq, ak.banded_attention_dkv)
    before = [dict(w.launches_by_body) for w in wrappers]
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = ak.banded_flash_attention(*leaves, 0, lengths, chunk_size=C, left_context=L)
    (out.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    for w, b0 in zip(wrappers, before):
        assert w.launches_by_body[body] == b0[body] + 1
    pad = lambda a: torch.nn.functional.pad(a.reshape(B, T, Dh), (0, 0, 0, T1 - T))  # noqa: E731
    q3, k3, v3, g3 = (pad(a).contiguous() for a in (q, k, v, cot))
    args = (0, lengths, C, L, T, QB, 1)
    r_out, r_lse = ak.banded_attention_fwd_reference(q3, k3, v3, *args)
    valid = (torch.arange(T, device="cuda")[None] < lengths[:, None])[..., None, None]
    torch.testing.assert_close(torch.where(valid, out.float(), 0.0),
                               torch.where(valid, r_out[:, :T].reshape(B, T, 1, Dh).float(), 0.0),
                               **TOL[dtype])
    bwd = (q3, k3, v3, g3, r_lse, ak._delta(g3, r_out, 1), *args)
    dk, dv = ak.banded_attention_dkv(*bwd)
    r_dk, r_dv = ak.banded_attention_dkv_reference(*bwd)
    for got, want in ((ak.banded_attention_dq(*bwd), ak.banded_attention_dq_reference(*bwd)),
                      (dk, r_dk), (dv, r_dv)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == torch.float32:
        n = [w.launches for w in wrappers]
        big = [torch.nn.functional.pad(a.reshape(B, T, Dh), (0, 0, 0, 128 - T)).contiguous()
               for a in (q, k, v)]
        with pytest.raises(ValueError, match="shared memory"):
            ak.banded_attention_fwd(*big, 0, lengths, C, L, T, 128, 1)
        with pytest.raises(ValueError, match="shared memory"):
            ak.banded_flash_attention(q, k, v, 0, lengths, chunk_size=C, left_context=L,
                                      query_rows=128)
        assert [w.launches for w in wrappers] == n


@pytest.mark.gpu
def test_planners_agree_with_the_kernels_shared_memory():
    """The Python planners' shared-memory sums equal the CUDA sources'."""
    _need_cuda()
    import ctypes

    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    tc = _build.load_library("banded_attention_tc").banded_attention_fwd_tc_smem
    tc.argtypes, tc.restype = [ctypes.c_int] * 3, ctypes.c_int
    for QB, W, Dh in ((128, 144, 64), (40, 48, 20), (32, 64, 96)):
        assert tc(QB, W, Dh) == ak._k2f_tc_smem(QB, W, Dh)
    from ecog2txt_tpu_torch.ops.attention_kernels import _k2b_tc_smem

    for kernel in ("dq", "dkv"):
        fn = getattr(_build.load_library("banded_attention_bwd_tc"),
                     f"banded_attention_{kernel}_tc_smem")
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        for QB, W, Dh in ((128, 144, 64), (40, 48, 20), (96, 112, 256), (128, 132, 16)):
            assert fn(QB, W, Dh) == _k2b_tc_smem(f"K2b-{kernel}", QB, W, Dh)
    fu = _build.load_library("fused_attention_tc").fused_attention_fwd_tc_smem
    fu.argtypes, fu.restype = [ctypes.c_int] * 3, ctypes.c_int
    for QB, W, Dh in ((128, 144, 64), (32, 48, 64), (128, 132, 16), (20, 24, 48),
                      (32, 48, 454), (32, 48, 512)):
        assert fu(QB, W, Dh) == ak._fused_tc_smem(QB, W, Dh)
    cl = _build.load_library("lstm_bwd_cluster").lstm_recurrence_bwd_cluster_smem
    cl.argtypes, cl.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    for H, cs in ((400, 8), (100, 2), (64, 1), (17, 4)):
        assert cl(H, cs) == lstm_kernels._cluster_smem(H, cs)
    fw = _build.load_library("lstm_recurrence").lstm_recurrence_fwd_cluster_smem
    fw.argtypes, fw.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for H, cs in ((400, 8), (100, 2), (64, 1), (17, 4)):
        for rows in (16, 32):
            assert fw(H, cs, rows) == lstm_kernels._fwd_cluster_smem(H, cs, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_main_paths_select_the_body_by_dtype(dtype):
    """A biLSTM training step and a flash conformer call: bf16 launches
    the cluster K1f and K1b and the tensor-core K2f, f32 the rows K1f and
    K1b and the CUDA-core K2f, every launch counted once in
    ``launches_by_body``."""
    _need_cuda()
    import numpy as np

    from ecog2txt_tpu_torch.models.conformer import ConformerConfig, conformer_encode, init_conformer
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    bf16 = dtype == torch.bfloat16
    K1f, K1b, K2f = lstm_kernels.lstm_recurrence, lstm_kernels.lstm_recurrence_bwd, \
        ak.banded_attention_fwd
    r0, b0, f0 = (dict(K.launches_by_body) for K in (K1f, K1b, K2f))
    xw, wh, lengths, h0, c0, mask = _inputs(dtype, False)
    leaves = [xw.clone().requires_grad_(), wh.float().clone().requires_grad_()]
    out, _, _ = lstm_kernels.fused_lstm_recurrence(leaves[0], leaves[1], lengths, h0, c0, mask)
    out.float().sum().backward()
    ccfg = ConformerConfig(num_blocks=1, model_dim=32, num_heads=2, ffn_dim=64, conv_kernel=4,
                           chunk_size=4, attention_impl="flash")
    params = init_conformer(torch.Generator().manual_seed(0), ccfg, 7, "cuda")
    x = torch.randn((2, 40, 7), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.inference_mode():
        y, _ = conformer_encode(params, ccfg, x, torch.tensor([40, 23], dtype=torch.int32,
                                                               device="cuda"), compute_dtype=dtype)
    assert np.isfinite(y.float().cpu().numpy()).all()
    k1f = {k: K1f.launches_by_body[k] - r0[k] for k in r0}
    k1b = {k: K1b.launches_by_body[k] - b0[k] for k in b0}
    k2f = {k: K2f.launches_by_body[k] - f0[k] for k in f0}
    assert k1f == ({"cluster": 1, "rows": 0} if bf16 else {"cluster": 0, "rows": 1})
    assert k1b == ({"cluster": 1, "rows": 0} if bf16 else {"cluster": 0, "rows": 1})
    assert k2f == ({"tensor_core": 1, "cuda_core": 0} if bf16 else
                   {"tensor_core": 0, "cuda_core": 1})


# --------------------------------------------------------------------------
# the one-launch biLSTM grid (K4f, K4b) and LayerNorm (K5f, K5b)
# --------------------------------------------------------------------------


def _grid_inputs(dtype, seed=7):
    """Both directions' projections and weights, ragged lengths with a
    zero, 0/2 masks."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    xw = [rand(T, B, 4 * H).to(dtype) for _ in "fb"]
    wh = [(rand(H, 4 * H) / H ** 0.5).to(dtype) for _ in "fb"]
    lengths = torch.tensor([T, 1, 4, 0, 7], dtype=torch.int32)
    masks = [(torch.rand((B, H), generator=g) < 0.5).float() * 2.0 for _ in "fb"]
    return [a.cuda() for a in (*xw, *wh, lengths, *masks)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_kernels_match_plain_versions(dtype):
    """K4f and K4b each launch once and match their plain versions; K4b
    runs on the residuals of the plain forward with nonzero upstream
    gradients."""
    _need_cuda()
    args = _grid_inputs(dtype)
    f0, b0 = lstm_kernels.bilstm_grid_fwd.launches, lstm_kernels.bilstm_grid_bwd.launches
    got = lstm_kernels.bilstm_grid_fwd(*args)
    torch.cuda.synchronize()
    want = lstm_kernels.bilstm_grid_fwd_reference(*args)
    for name, g, w in zip(("hf", "hb", "cf", "cb", "hT", "cT"), got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype], msg=name)
    hf, hb, cf, cb, _, _ = want
    zeros = torch.zeros((B, H), device="cuda")
    gen = torch.Generator().manual_seed(8)
    bargs = (*args[:4], lstm_kernels._shifted(hf, zeros, False),
             lstm_kernels._shifted(hb, zeros, True), lstm_kernels._shifted(cf, zeros, False),
             lstm_kernels._shifted(cb, zeros, True), cf, cb, *args[4:],
             *(torch.randn((T, B, H), generator=gen).to(dtype).cuda() for _ in "fb"),
             *(torch.randn((2, B, H), generator=gen).cuda() for _ in "hc"))
    got = lstm_kernels.bilstm_grid_bwd(*bargs)
    torch.cuda.synchronize()
    assert lstm_kernels.bilstm_grid_fwd.launches == f0 + 1
    assert lstm_kernels.bilstm_grid_bwd.launches == b0 + 1
    want = lstm_kernels.bilstm_grid_bwd_reference(*bargs)
    for name, g, w in zip(("dgf", "dgb", "dh0", "dc0"), got, want):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype], msg=name)


@pytest.mark.gpu
def test_grid_function_gradients_match_plain_autograd():
    """``fused_bilstm_grid`` (K4f, K4b + two GEMMs) against autograd
    through the plain forward, f32; the weights' gradients stay f32."""
    _need_cuda()
    xwf, xwb, whf, whb, lengths, maskf, maskb = _grid_inputs(torch.float32)
    w_out = torch.randn((2 * H,), generator=torch.Generator().manual_seed(9)).cuda()

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (xwf, xwb, whf, whb)]
        out, hT, cT = fn(*leaves)
        ((out * w_out).sum() + 2.0 * hT.sum() + 0.5 * (cT ** 2).sum()).backward()
        return [a.grad for a in leaves]

    f0, b0 = lstm_kernels.bilstm_grid_fwd.launches, lstm_kernels.bilstm_grid_bwd.launches
    got = grads(lambda *a: lstm_kernels.fused_bilstm_grid(*a, lengths, maskf, maskb))
    assert lstm_kernels.bilstm_grid_fwd.launches == f0 + 1
    assert lstm_kernels.bilstm_grid_bwd.launches == b0 + 1

    def plain(xf, xb, wf, wb):
        hf, hb, _, _, hT, cT = lstm_kernels.bilstm_grid_fwd_reference(
            xf, xb, wf, wb, lengths, maskf, maskb)
        return torch.cat([hf, hb], -1), torch.cat([hT[0], hT[1]], -1), torch.cat([cT[0], cT[1]], -1)

    for g, w in zip(got, grads(plain)):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D", [(130, 64), (37, 100), (200, 384)])
def test_layernorm_kernels_match_plain_versions(dtype, rows, D):
    """K5f and K5b each launch once and match their plain versions (dg and
    db as the sums of their per-block partials), at widths that are not
    multiples of 128 and row counts that fill no whole block."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import layernorm_kernels as ln

    g = torch.Generator().manual_seed(rows + D)
    x = (torch.randn((rows, D), generator=g) * 3 + 1).to(dtype).cuda()
    dy = torch.randn((rows, D), generator=g).to(dtype).cuda()
    lng = (1 + 0.2 * torch.randn((D,), generator=g)).cuda()
    lnb = (0.1 * torch.randn((D,), generator=g)).cuda()
    f0, b0 = ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches
    y = ln.layer_norm_fwd(x, lng, lnb)
    dx, dg, db = ln.layer_norm_bwd(x, dy, lng)
    torch.cuda.synchronize()
    assert (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches) == (f0 + 1, b0 + 1)
    assert y.dtype == dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    torch.testing.assert_close(y.float(), ln.layer_norm_fwd_reference(x, lng, lnb).float(),
                               **TOL[dtype])
    rdx, rdg, rdb = ln.layer_norm_bwd_reference(x, dy, lng)
    torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
    for got, want in ((dg.sum(0), rdg.sum(0)), (db.sum(0), rdb.sum(0))):
        torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.gpu
def test_layer_norm_function_gradients_match_plain_autograd():
    """``layer_norm`` (K5f, K5b + one sum) against autograd through the
    plain forward, f32; dg and db stay f32."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import layernorm_kernels as ln

    g = torch.Generator().manual_seed(10)
    leaves = [torch.randn((3, 11, 64), generator=g).cuda(),
              (1 + 0.2 * torch.randn((64,), generator=g)).cuda(),
              (0.1 * torch.randn((64,), generator=g)).cuda()]

    def grads(fn):
        ls = [a.clone().requires_grad_() for a in leaves]
        fn(*ls).sin().sum().backward()
        return [a.grad for a in ls]

    for got, want in zip(grads(ln.layer_norm), grads(ln.layer_norm_fwd_reference)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.gpu
def test_bi_grid_training_step_launches_the_grid_kernels():
    """One segment-runner step of a small biLSTM seq2seq under
    ``use_pallas_lstm='bi_grid'`` (bf16, dropout on): each layer launches
    K4f and K4b once, K1f and K1b never, and the loss is finite."""
    _need_cuda()
    import numpy as np

    from ecog2txt_tpu_torch.convert import tree_map
    from ecog2txt_tpu_torch.models.seq2seq import AuxHead, Seq2SeqConfig, init_seq2seq
    from ecog2txt_tpu_torch.train import TrainState, make_optimizer, make_segment_runner

    cfg = Seq2SeqConfig(
        vocab_size=30, in_channels=7, conv_sizes=(16,), decimation_factor=4,
        rnn_sizes=(H, H), aux_proj_sizes=(8,),
        aux_heads=(AuxHead("aux", "categorical", 5),), dec_embedding_size=8,
        dec_rnn_sizes=(2 * H,), max_dec_len=6, compute_dtype=torch.bfloat16,
        use_pallas_lstm="bi_grid",
    )
    params = init_seq2seq(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    N, Traw = 8, 48
    dec = torch.randint(3, 30, (1, N, 6), generator=g, dtype=torch.int32)
    dec[..., -1] = 1
    data = {
        "encoder_inputs": torch.randn((1, N, Traw, 7), generator=g).bfloat16(),
        "encoder_lengths": torch.randint(12, Traw + 1, (1, N), generator=g,
                                         dtype=torch.int32),
        "decoder_targets": dec,
        "decoder_lengths": torch.full((1, N), 6, dtype=torch.int32),
        "aux": torch.randint(0, 5, (1, N, Traw), generator=g, dtype=torch.int32),
    }
    data = {k: v.cuda() for k, v in data.items()}
    state = TrainState(params, tree_map(lambda t: t.detach().clone(), params),
                       make_optimizer(params, 1e-3), 0)
    runner = make_segment_runner(cfg, {"aux": 1.0}, 0.99)
    wrappers = (lstm_kernels.lstm_recurrence, lstm_kernels.lstm_recurrence_bwd,
                lstm_kernels.bilstm_grid_fwd, lstm_kernels.bilstm_grid_bwd)
    before = [w.launches for w in wrappers]
    state, metrics = runner(state, data, np.zeros(1, np.int32),
                            np.arange(4, dtype=np.int32)[None],
                            torch.Generator(device="cuda").manual_seed(0), 1)
    assert np.isfinite(float(metrics["loss_total"]))
    assert [w.launches - b for w, b in zip(wrappers, before)] == [0, 0, 2, 2]


# --------------------------------------------------------------------------
# K4b on the cluster body, K2b on the tensor cores, the LSTM width limit
# --------------------------------------------------------------------------


def _k4b_cluster_case(B, Hw, T, seed):
    """K4b inputs from a real forward pass of both chains (the plain
    recurrences), ragged lengths with a zero, 0/2 masks, nonzero upstream
    gradients, bf16."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    xw = [rand(T, B, 4 * Hw).bfloat16().cuda() for _ in "fb"]
    wh = [(rand(Hw, 4 * Hw) / Hw ** 0.5).bfloat16().cuda() for _ in "fb"]
    lengths = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0] = T if B == 1 else 0
    lengths = lengths.cuda()
    masks = [((torch.rand((B, Hw), generator=g) < 0.5).float() * 2.0).cuda() for _ in "fb"]
    hf, hb, cf, cb, _, _ = lstm_kernels.bilstm_grid_fwd_reference(*xw, *wh, lengths, *masks)
    zeros = torch.zeros((B, Hw), device="cuda")
    hpf, cpf = (lstm_kernels._shifted(a, zeros, False) for a in (hf, cf))
    hpb, cpb = (lstm_kernels._shifted(a, zeros, True) for a in (hb, cb))
    dhs = [rand(T, B, Hw).bfloat16().cuda() for _ in "fb"]
    return (*xw, *wh, hpf, hpb, cpf, cpb, cf, cb, lengths, *masks, *dhs,
            rand(2, B, Hw).cuda(), rand(2, B, Hw).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("Hw", [100, 400])
@pytest.mark.parametrize("B", [1, 17, 256])
def test_k4b_cluster_body_matches_plain_version(B, Hw):
    """K4b's bf16 body (K1b's cluster body, a direction axis on the grid)
    against its plain version, padded B (1, 17) and H (100); two launches
    are bit-identical, and equal two K1b launches (the same body a
    direction) bit for bit."""
    _need_cuda()
    args = _k4b_cluster_case(B, Hw, 24, seed=B * 10 + Hw)
    K4b = lstm_kernels.bilstm_grid_bwd
    before = dict(K4b.launches_by_body)
    got = K4b(*args)
    again = K4b(*args)
    torch.cuda.synchronize()
    assert K4b.launches_by_body == {"cluster": before["cluster"] + 2, "rows": before["rows"]}
    want = lstm_kernels.bilstm_grid_bwd_reference(*args)
    (xwf, xwb, whf, whb, hpf, hpb, cpf, cpb, csf, csb, lengths, maskf, maskb,
     dhsf, dhsb, dhT, dcT) = args
    dgf, dh0f, dc0f = lstm_kernels.lstm_recurrence_bwd(
        xwf, whf, hpf, cpf, csf, lengths, maskf, dhsf, dhT[0], dcT[0])
    dgb, dh0b, dc0b = lstm_kernels.lstm_recurrence_bwd(
        xwb, whb, hpb, cpb, csb, lengths, maskb, dhsb, dhT[1], dcT[1], True)
    two = (dgf, dgb, torch.stack([dh0f, dh0b]), torch.stack([dc0f, dc0b]))
    for a, b, c, w in zip(got, again, two, want):
        assert torch.equal(a, b) and torch.equal(a, c)
        torch.testing.assert_close(a.float(), w.float(), **TOL[torch.bfloat16])


@pytest.mark.gpu
def test_k4b_keeps_the_rows_body_for_f32():
    _need_cuda()
    args = [a.float() if a.dtype == torch.bfloat16 else a
            for a in _k4b_cluster_case(5, 64, 9, seed=3)]
    K4b = lstm_kernels.bilstm_grid_bwd
    before = dict(K4b.launches_by_body)
    got = K4b(*args)
    torch.cuda.synchronize()
    assert K4b.launches_by_body == {"cluster": before["cluster"], "rows": before["rows"] + 1}
    for a, w in zip(got, lstm_kernels.bilstm_grid_bwd_reference(*args)):
        torch.testing.assert_close(a, w, **TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "Dh, C, L, QB, offset, t_real",
    [(64, 16, 1, 128, 0, 104), (16, 4, 1, 128, 0, 100), (48, 8, 2, 32, 16, 90),
     (96, 8, 1, 40, 0, 100), (64, 16, 1, 48, 256, 100), (20, 4, 2, 24, 8, 70),
     (256, 16, 1, 96, 32, 100)],
)
def test_k2b_tensor_core_bodies_match_plain_versions(Dh, C, L, QB, offset, t_real):
    """The bf16 bodies of K2b-dq and K2b-dkv at padded shapes (head dims
    16 to 256, one not a multiple of 8; query blocks of 24 to 128 rows;
    offsets > 0; t_real < T1; ragged lengths, one ending inside a chunk
    and one before the first chunk's end) against their plain versions,
    every row."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    H, B = 2, 3
    T1 = -(-t_real // QB) * QB
    g = torch.Generator().manual_seed(Dh + QB + offset)
    q, k, v, gout = (torch.randn((B, T1, H * Dh), generator=g).bfloat16().cuda()
                     for _ in range(4))
    lengths = torch.tensor([t_real + offset, t_real + offset - 13, offset + 3],
                           dtype=torch.int32).cuda()
    args = (offset, lengths, C, L, t_real, QB, H)
    r_out, r_lse = ak.banded_attention_fwd_reference(q, k, v, *args)
    bwd = (q, k, v, gout, r_lse, ak._delta(gout, r_out, H), *args)
    before = [dict(w.launches_by_body) for w in (ak.banded_attention_dq, ak.banded_attention_dkv)]
    dq = ak.banded_attention_dq(*bwd)
    dk, dv = ak.banded_attention_dkv(*bwd)
    torch.cuda.synchronize()
    for w, b0 in zip((ak.banded_attention_dq, ak.banded_attention_dkv), before):
        assert w.launches_by_body == {"tensor_core": b0["tensor_core"] + 1,
                                      "cuda_core": b0["cuda_core"]}
    r_dk, r_dv = ak.banded_attention_dkv_reference(*bwd)
    for got, want in ((dq, ak.banded_attention_dq_reference(*bwd)), (dk, r_dk), (dv, r_dv)):
        assert bool(torch.isfinite(got.float()).all())
        torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])


@pytest.mark.gpu
def test_lstm_kernels_refuse_a_width_above_1024():
    """On a CUDA tensor the four LSTM wrappers refuse H > 1024 with a
    ValueError naming the width and the limit, before any launch."""
    _need_cuda()
    Tn, Bn, Hw = 2, 1, 1040
    z = torch.zeros((Bn, Hw), device="cuda")
    xw = torch.zeros((Tn, Bn, 4 * Hw), device="cuda")
    wh = torch.zeros((Hw, 4 * Hw), device="cuda")
    seq = torch.zeros((Tn, Bn, Hw), device="cuda")
    lengths = torch.full((Bn,), Tn, dtype=torch.int32, device="cuda")
    z2 = torch.zeros((2, Bn, Hw), device="cuda")
    counts = [w.launches for w in (lstm_kernels.lstm_recurrence, lstm_kernels.lstm_recurrence_bwd,
                                   lstm_kernels.bilstm_grid_fwd, lstm_kernels.bilstm_grid_bwd)]
    calls = (
        lambda: lstm_kernels.lstm_recurrence(xw, wh, lengths, z, z, z),
        lambda: lstm_kernels.lstm_recurrence_bwd(xw, wh, seq, seq, seq, lengths, z, seq, z, z),
        lambda: lstm_kernels.bilstm_grid_fwd(xw, xw, wh, wh, lengths, z, z),
        lambda: lstm_kernels.bilstm_grid_bwd(xw, xw, wh, wh, seq, seq, seq, seq, seq, seq,
                                             lengths, z, z, seq, seq, z2, z2),
    )
    for call in calls:
        with pytest.raises(ValueError, match="H=1040 is above the CUDA kernels' limit H <= 1024"):
            call()
    assert counts == [w.launches for w in (
        lstm_kernels.lstm_recurrence, lstm_kernels.lstm_recurrence_bwd,
        lstm_kernels.bilstm_grid_fwd, lstm_kernels.bilstm_grid_bwd)]


def _fused_case(B, T, H, Dh, C, L, offset, ragged, seed):
    """bf16 K3f inputs (x, weights, LayerNorm parameters) at T1 a multiple
    of the query block :func:`plan_fused_layer` takes on the card, lengths
    full or ragged (row 0 ends 5 steps early, inside a chunk), and the
    valid-row mask."""
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    D = H * Dh
    QB, body = ak.plan_fused_layer(torch.bfloat16, B, T, H, 128, C, L, Dh,
                                   ak._smem_limit("cuda"), ak._sm_count("cuda"))
    T1 = -(-T // QB) * QB
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T1, D), generator=g).bfloat16().cuda()
    xw = ak._split_rot_weights((torch.randn((D, 3 * D), generator=g) / D ** 0.5).cuda(), H,
                               torch.bfloat16)
    ln = ((1 + 0.1 * torch.randn((D,), generator=g)).cuda(),
          (0.1 * torch.randn((D,), generator=g)).cuda())
    lengths = torch.full((B,), T, dtype=torch.int32)
    if ragged:
        lengths = torch.randint(max(T // 2, 1), T + 1, (B,), generator=g, dtype=torch.int32)
        lengths[0] = T - 5
    lengths = (lengths + offset).cuda()
    pos = torch.arange(T1).cuda() + offset
    valid = ((torch.arange(T1).cuda()[None] < T) & (pos[None] >= 0)
             & (pos[None] < lengths[:, None]))[..., None]
    return x, xw, ln, valid, (offset, lengths, C, L, T, QB, H), body


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B, T, H, Dh, C, L, offset, ragged",
    [(1, 104, 6, 64, 16, 1, 0, False), (17, 104, 6, 64, 16, 1, 0, True),
     (256, 104, 6, 64, 16, 1, 0, True), (2, 144, 6, 64, 16, 1, 256, True),
     (3, 100, 8, 48, 16, 1, 0, True), (3, 100, 4, 96, 16, 1, 32, False),
     (16, 24, 4, 16, 4, 1, 0, True),
     (2, 100, 1, 288, 16, 1, 0, True), (2, 100, 1, 384, 16, 1, 0, True),
     (2, 100, 1, 454, 16, 1, 0, True), (2, 100, 1, 512, 16, 1, 0, True)],
)
def test_k3f_tensor_core_body_matches_plain_version(B, T, H, Dh, C, L, offset, ragged):
    """The bf16 body of K3f on the tensor cores, at the query block the layer
    plans (the headline head dim at B=1, 17 and 256; a chunk-aligned
    offset; head dims 48, 96, the demo's 16 and the wide 288-512 at chunk
    16): it is the planned body, it launches once, and out, q, k, v and lse
    match the plain version within the bf16 tolerance (out and lse on valid
    rows: the scores come from bf16 q and k whose products sum in another
    order), with and without saving the residuals."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    x, xw, (ln_g, ln_b), valid, args, body = _fused_case(B, T, H, Dh, C, L, offset, ragged,
                                                         B * 1000 + Dh)
    assert body == "tensor_core"
    before = dict(ak.fused_attention_fwd.launches_by_body)
    got = ak.fused_attention_fwd(x, xw, ln_g, ln_b, *args, True)
    (unsaved,) = ak.fused_attention_fwd(x, xw, ln_g, ln_b, *args, False)
    torch.cuda.synchronize()
    assert ak.fused_attention_fwd.launches_by_body == {
        "tensor_core": before["tensor_core"] + 2, "cuda_core": before["cuda_core"]}
    want = ak.fused_attention_fwd_reference(x, xw, ln_g, ln_b, *args, True)
    rows = lambda a: torch.where(valid, a.float(), 0.0)  # noqa: E731
    assert torch.equal(unsaved, got[0])
    for name, a, w in zip(("out", "q", "k", "v", "lse"), got, want):
        assert bool(torch.isfinite(a.float()).all()), name
        if name in ("out", "lse"):
            a, w = rows(a), rows(w)
        torch.testing.assert_close(a.float(), w.float(), **TOL[torch.bfloat16], msg=name)


@pytest.mark.gpu
def test_k3f_tensor_core_body_repeats_and_keeps_rows_apart():
    """The tensor-core K3f at the headline head dim, ragged lengths: two
    launches agree bit for bit, and batch row 0 of B=17 equals the same row
    run alone (B=1) bit for bit, at one query block."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import attention_kernels as ak

    x, xw, (ln_g, ln_b), _, args, _ = _fused_case(17, 104, 6, 64, 16, 1, 0, True, 5)
    a = ak.fused_attention_fwd(x, xw, ln_g, ln_b, *args, True)
    b = ak.fused_attention_fwd(x, xw, ln_g, ln_b, *args, True)
    offset, lengths, *rest = args
    one = ak.fused_attention_fwd(x[:1].contiguous(), xw, ln_g, ln_b, offset,
                                 lengths[:1].contiguous(), *rest, True)
    torch.cuda.synchronize()
    for p, q, r in zip(a, b, one):
        assert torch.equal(p, q)
        assert torch.equal(p[:1], r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, D", [(37, 100), (389, 64), (26624, 384), (131072, 384)])
def test_k5b_registers_body_matches_plain_version(dtype, rows, D):
    """K5b's registers body (each row read once) at an odd width, the demo's
    width and the headline and long-recording rows: it is the planned body,
    dx matches the plain version within the dtype's tolerance and dg, db
    (sums of the per-block partials) within f32's, held normwise (they sum
    every row in another order), and a second launch agrees bit for bit."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import layernorm_kernels as ln

    g = torch.Generator().manual_seed(rows + D)
    x = (torch.randn((rows, D), generator=g) * 3 + 1).to(dtype).cuda()
    dy = torch.randn((rows, D), generator=g).to(dtype).cuda()
    lng = (1 + 0.2 * torch.randn((D,), generator=g)).cuda()
    before = dict(ln.layer_norm_bwd.launches_by_body)
    dx, dg, db = ln.layer_norm_bwd(x, dy, lng)
    dx2, dg2, db2 = ln.layer_norm_bwd(x, dy, lng)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd.launches_by_body == {"registers": before["registers"] + 2,
                                                  "columns": before["columns"]}
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2) and torch.equal(db, db2)
    rdx, rdg, rdb = ln.layer_norm_bwd_reference(x, dy, lng)
    torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
    tol = TOL[torch.float32]
    for got, want in ((dg.sum(0), rdg.sum(0)), (db.sum(0), rdb.sum(0))):
        assert float((got - want).abs().max()) <= tol["atol"] + tol["rtol"] * float(
            want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5b_columns_body_takes_wide_rows(dtype):
    """Rows too wide for a warp's registers (D=1040: five 16-byte chunks a
    lane in bf16, nine in f32) run K5b's columns body, summed by the same
    second launch, and match the plain version."""
    _need_cuda()
    from ecog2txt_tpu_torch.ops import layernorm_kernels as ln

    rows, D = 50, 1040
    g = torch.Generator().manual_seed(7)
    x = (torch.randn((rows, D), generator=g) * 3 + 1).to(dtype).cuda()
    dy = torch.randn((rows, D), generator=g).to(dtype).cuda()
    lng = (1 + 0.2 * torch.randn((D,), generator=g)).cuda()
    before = dict(ln.layer_norm_bwd.launches_by_body)
    dx, dg, db = ln.layer_norm_bwd(x, dy, lng)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd.launches_by_body == {"registers": before["registers"],
                                                  "columns": before["columns"] + 1}
    assert dg.shape == db.shape == (1, D)
    rdx, rdg, rdb = ln.layer_norm_bwd_reference(x, dy, lng)
    torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
    for got, want in ((dg, rdg), (db, rdb)):
        torch.testing.assert_close(got, want, **TOL[torch.float32])


# --------------------------------------------------------------------------
# beam search, the conformer session and pool, export: the card's paths
# --------------------------------------------------------------------------


def _serving_config(dtype=torch.bfloat16, use_pallas_lstm=True, **extra):
    """The JAX benchmark's biLSTM at full width (bench.py:46-63)."""
    from ecog2txt_tpu_torch.models.seq2seq import AuxHead, Seq2SeqConfig

    return Seq2SeqConfig(
        vocab_size=1809, in_channels=469, conv_sizes=(100,), decimation_factor=12,
        rnn_sizes=(400, 400, 400), aux_proj_sizes=(225,),
        aux_heads=(AuxHead("encoder_1_targets", "categorical", 45),),
        dec_embedding_size=150, dec_rnn_sizes=(800,), max_dec_len=20,
        compute_dtype=dtype, use_pallas_lstm=use_pallas_lstm, **extra,
    )


def _ctc_conformer_config(dtype, impl):
    """The headline conformer (bench.py:149-157) with a CTC head of 21 classes."""
    from ecog2txt_tpu_torch.models.conformer import ConformerConfig
    from ecog2txt_tpu_torch.models.seq2seq import AuxHead

    conformer = ConformerConfig(num_blocks=4, model_dim=384, num_heads=6, ffn_dim=1536,
                                conv_kernel=8, chunk_size=16, left_context=1,
                                attention_impl=impl)
    return dataclasses.replace(
        _serving_config(dtype, False, encoder_type="conformer", conformer=conformer),
        aux_heads=(AuxHead("encoder_1_targets", "CTC", 21),),
    )


_TARGETS = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 1809)]


def _params(config):
    from ecog2txt_tpu_torch.models.seq2seq import init_seq2seq

    return init_seq2seq(config, torch.Generator().manual_seed(0), device="cuda")


def _raw(n, seed=0, rows=None):
    g = torch.Generator().manual_seed(seed)
    shape = (n, 469) if rows is None else (rows, n, 469)
    return torch.randn(shape, generator=g).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("mode,kernel,per_encode", [(True, "lstm_recurrence", 6),
                                                    ("bi_grid", "bilstm_grid_fwd", 3)])
def test_beam_decode_launches_the_lstm_kernels(mode, kernel, per_encode):
    from ecog2txt_tpu_torch.models.beam import beam_decode
    from ecog2txt_tpu_torch.models.seq2seq import greedy_decode

    _need_cuda()
    wrapper = getattr(lstm_kernels, kernel)
    x = torch.from_numpy(_raw(1248, rows=4)).cuda()
    lens = torch.tensor([1248, 1000, 700, 1248], dtype=torch.int32, device="cuda")
    config = _serving_config(use_pallas_lstm=mode)
    params = _params(config)
    before = wrapper.launches
    with torch.inference_mode():
        hyps, scores = beam_decode(params, config, x, lens, 0, beam_width=4, return_all=True)
    torch.cuda.synchronize()
    assert wrapper.launches == before + per_encode
    assert tuple(hyps.shape) == (4, 4, 20) and bool(torch.isfinite(scores).all())
    assert bool((scores[:, 1:] <= scores[:, :-1] + 1e-6).all())
    f32 = _serving_config(torch.float32, mode)
    p32 = _params(f32)
    with torch.inference_mode():
        beam1 = beam_decode(p32, f32, x, lens, 0, beam_width=1, alpha=0.0)
        greedy = greedy_decode(p32, f32, x, lens, 0, temperature=0.0)
    assert torch.equal(beam1, greedy)


@pytest.mark.gpu
@pytest.mark.parametrize("impl,kernel", [("flash", "banded_attention_fwd"),
                                         ("fused", "fused_attention_fwd")])
def test_streaming_session_endpoint_equals_the_offline_decode(impl, kernel):
    import numpy as np

    from ecog2txt_tpu_torch.models.seq2seq import greedy_decode
    from ecog2txt_tpu_torch.ops import attention_kernels
    from ecog2txt_tpu_torch.serve import StreamingConformerSession

    _need_cuda()
    wrapper = getattr(attention_kernels, kernel)
    config = _ctc_conformer_config(torch.float32, impl)
    params = _params(config)
    raw = _raw(1000, seed=1)
    session = StreamingConformerSession(params, config, _TARGETS, device="cuda")
    before = wrapper.launches
    for pkt in np.split(raw, [130, 333, 500, 777]):
        session.push(pkt)
    a, b = session.decode(), session.decode()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    got = session.endpoint()
    # 5 whole chunks and the flushed remainder three times: 8 window encodes
    assert wrapper.launches == before + 8 * 4
    padded = np.zeros((1, 1008, 469), np.float32)
    padded[0, :1000] = raw
    with torch.inference_mode():
        want = greedy_decode(params, config, torch.from_numpy(padded).cuda(),
                             torch.tensor([1000], device="cuda"), 0, temperature=0.0)
    np.testing.assert_array_equal(got["tokens"], want.cpu().numpy())
    np.testing.assert_array_equal(a["tokens"], got["tokens"])


@pytest.mark.gpu
def test_pool_equals_dedicated_sessions_on_the_card():
    import numpy as np

    from ecog2txt_tpu_torch.ops import attention_kernels, layernorm_kernels
    from ecog2txt_tpu_torch.serve import StreamingConformerSession, StreamingSessionPool

    _need_cuda()
    config = _ctc_conformer_config(torch.float32, "flash")
    dense = _ctc_conformer_config(torch.float32, "dense")
    params = _params(config)
    pool = StreamingSessionPool(params, config, _TARGETS, capacity=8, device="cuda")
    raws = [_raw(n, seed=s) for s, n in enumerate((1248, 700, 431))]
    slots = [pool.add() for _ in raws]
    k2f, k5f = attention_kernels.banded_attention_fwd.launches, layernorm_kernels.layer_norm_fwd.launches
    for lo in range(0, 1248, 97):
        for slot, raw in zip(slots, raws):
            if lo < len(raw):
                pool.push(slot, raw[lo: lo + 97])
    outs = [pool.endpoint(slot) for slot in slots]
    assert attention_kernels.banded_attention_fwd.launches == k2f  # the window is pinned dense
    assert layernorm_kernels.layer_norm_fwd.launches > k5f
    for raw, got in zip(raws, outs):
        session = StreamingConformerSession(params, dense, _TARGETS, device="cuda")
        session.push(raw)
        want = session.endpoint()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        torch.testing.assert_close(torch.from_numpy(got["encoder_outputs"]),
                                   torch.from_numpy(want["encoder_outputs"]), **TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("mode,kernel,per_call", [(True, "lstm_recurrence", 12),
                                                  ("bi_grid", "bilstm_grid_fwd", 6)])
def test_exported_predictor_launches_the_kernels(tmp_path, mode, kernel, per_call):
    import numpy as np

    from ecog2txt_tpu_torch.serve import (
        OnlinePredictor,
        export_predictor,
        load_exported_predictor,
    )

    _need_cuda()
    wrapper = getattr(lstm_kernels, kernel)
    config = _serving_config(use_pallas_lstm=mode)
    live = OnlinePredictor(_params(config), config, _TARGETS, max_samples=1248, device="cuda")
    loaded = load_exported_predictor(export_predictor(live, str(tmp_path / "artifact")))
    assert loaded.meta["platforms"] == ["cuda"]
    for x in (_raw(1248, seed=2), _raw(900, seed=3, rows=3)):
        before = wrapper.launches
        got = loaded(x)
        assert wrapper.launches == before + per_call
        np.testing.assert_array_equal(got["tokens"], live(x)["tokens"])


# the MoE FFN, int8 serving and the raw-voltage front end on the card


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(1, 100, 384), (16, 100, 384), (17, 100, 1152),
                                   (104, 384, 1536), (5, 1536, 384)])
def test_int8_gemm_pads_and_stays_exact(M, K, N):
    """``int8_mm`` on the card (``torch._int_mm`` padded with zeros to more
    than 16 rows and to multiples of 8 in K and N) equals the float64
    product of the same int8 operands exactly, extremes included."""
    from ecog2txt_tpu_torch.quantize import int8_mm

    _need_cuda()
    g = torch.Generator().manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    a[0], b[:, 0] = 127, -127
    before = int8_mm.launches
    got = int8_mm(a.cuda(), b.cuda())
    assert int8_mm.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert torch.equal(got.cpu(), (a.double() @ b.double()).to(torch.int32))
    assert int(got[0, 0]) == -127 * 127 * K


@pytest.mark.gpu
def test_router_ties_pick_the_lowest_experts_on_the_card():
    """A zero router (every probability equal) picks experts 0..k-1 on the
    card, and a random router the CPU's experts."""
    from ecog2txt_tpu_torch.models.moe import _route

    _need_cuda()
    g = torch.Generator().manual_seed(0)
    xn = torch.randn((4, 300, 64), generator=g)
    p = {"wg": torch.zeros((64, 8))}
    for k in (1, 2, 3):
        _, _, gates, idx = _route({"wg": p["wg"].cuda()}, xn.cuda(), k)
        assert bool((idx.cpu() == torch.arange(k)).all())
        torch.testing.assert_close(gates.cpu(), torch.full_like(gates.cpu(), 1.0 / k))
    wg = torch.randn((64, 8), generator=g)
    _, _, _, cpu_idx = _route({"wg": wg}, xn, 2)
    _, _, _, gpu_idx = _route({"wg": wg.cuda()}, xn.cuda(), 2)
    assert torch.equal(gpu_idx.cpu(), cpu_idx)


@pytest.mark.gpu
@pytest.mark.parametrize("cf,seg", [(0.0, 0), (1.25, 64)])
def test_moe_ffn_on_the_card_matches_the_cpu(cf, seg):
    """The no-drop and grouped capacity paths on the card against the CPU,
    f32: outputs and statistics; the capacity path keeps the CPU's pairs."""
    from ecog2txt_tpu_torch.convert import tree_map
    from ecog2txt_tpu_torch.models.conformer import ConformerConfig
    from ecog2txt_tpu_torch.models.moe import _route, capacity_slots, init_moe_ffn, moe_ffn

    _need_cuda()
    cfg = ConformerConfig(model_dim=64, ffn_dim=96, moe_experts=8, moe_topk=2,
                          moe_capacity_factor=cf, moe_group_size=seg)
    p = init_moe_ffn(torch.Generator().manual_seed(1), 64, 96, 8)
    xn = torch.randn((3, 150, 64), generator=torch.Generator().manual_seed(2))
    valid = torch.arange(150)[None] < torch.tensor([150, 99, 120])[:, None]
    want, want_stats = moe_ffn(p, xn, cfg, torch.float32, valid)
    got, stats = moe_ffn(tree_map(lambda t: t.cuda(), p), xn.cuda(), cfg, torch.float32,
                         valid.cuda())
    torch.testing.assert_close(got.cpu(), want, **TOL[torch.float32])
    for k in want_stats:
        torch.testing.assert_close(stats[k].cpu(), want_stats[k], **TOL[torch.float32])
    if cf:
        xg = xn[:, :128].reshape(-1, 64, 64)
        vg = valid[:, :128].reshape(-1, 64)
        _, _, _, idx = _route(p, xg, 2)
        C = int(-(-2 * 64 * 1.25 // 8))
        cpu = capacity_slots(idx, vg, 8, C)
        gpu = capacity_slots(idx.cuda(), vg.cuda(), 8, C)
        for a, b in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("zscore", ["none", "trial"])
def test_featurization_on_the_card_matches_the_cpu(zscore):
    """``extract_high_gamma_np`` on the card (cuFFT, the f64 decimation)
    against the CPU, f32, float and int16 input; the streaming front end
    on the card against the offline chain."""
    import numpy as np

    from ecog2txt_tpu_torch.features import (
        HighGammaConfig,
        StreamingHighGamma,
        extract_high_gamma_np,
    )

    _need_cuda()
    cfg = HighGammaConfig(raw_rate=3200.0, out_rate=200.0, zscore=zscore, input_scale=1e-3)
    raw = np.random.default_rng(0).standard_normal((9000, 33)).astype(np.float32)
    ints = np.clip(raw * 1000, -32768, 32767).astype(np.int16)
    for x in (raw, ints):
        got = extract_high_gamma_np(x, cfg, device="cuda")
        want = extract_high_gamma_np(x, cfg, device="cpu")
        torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want),
                                   **TOL[torch.float32])
    if zscore == "none":
        stream = StreamingHighGamma(cfg, 33, window_seconds=1.0, device="cuda")
        outs = [stream.push(ints[lo: lo + 517]) for lo in range(0, len(ints), 517)]
        got = np.concatenate(outs + [stream.flush()])
        want = extract_high_gamma_np(ints, cfg, device="cpu")
        scale = np.abs(want).mean()
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3 * scale)


def collective_rank() -> dict:
    """One gloo rank's check of the tensor-parallel column gather and the
    pipeline ring on CUDA tensors (``parallel.comm``; run by
    ``parallel.launch.spawn``): forward values and adjoints against their
    definitions, and whether the calls staged through the host."""
    import torch.distributed as dist

    from ecog2txt_tpu_torch.parallel.comm import ring_shift, stages_through_host
    from ecog2txt_tpu_torch.parallel.mesh import gather_params_tp, make_mesh

    group, r, n = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    g = torch.Generator().manual_seed(0)
    pieces = [torch.randn((3, 5, 4), generator=g) for _ in range(n)]
    w = torch.randn((3, 5, 4 * n), generator=g).cuda()
    x = pieces[r].cuda().requires_grad_()
    y = gather_params_tp({"w": x}, make_mesh(n_data=1, n_model=n), {"w": True})["w"]
    (y * w).sum().backward()
    # the adjoint: this rank's block of the cotangent summed over the ranks
    gather_ok = (torch.equal(y.cpu(), torch.cat(pieces, dim=-1))
                 and torch.allclose(x.grad, n * w[..., 4 * r:4 * (r + 1)]))
    z_in = pieces[r].cuda().to(torch.bfloat16).requires_grad_()
    z = ring_shift(z_in, group)
    v = w[..., :4].to(torch.bfloat16)
    (z.float() * v.float()).sum().backward()
    want_z = pieces[r - 1].to(torch.bfloat16) if r else torch.zeros_like(z_in).cpu()
    # the adjoint: the shift back (the last rank sends nothing on)
    want_grad = v if r < n - 1 else torch.zeros_like(v)
    ring_ok = torch.equal(z.cpu(), want_z) and torch.equal(z_in.grad, want_grad)
    return {"gather_ok": bool(gather_ok), "ring_ok": bool(ring_ok),
            "staged": stages_through_host(group, x, "all_gather")
            and stages_through_host(group, z_in, "send")}


@pytest.fixture(scope="module")
def collective_ranks():
    import os

    from ecog2txt_tpu_torch.parallel.launch import spawn

    _need_cuda()
    return spawn("test_torch_gpu:collective_rank", 2, timeout=300, backend="gloo",
                 device="cuda", pythonpath=[os.path.dirname(os.path.abspath(__file__))])


@pytest.mark.gpu
def test_column_gather_adjoint_on_cuda_under_gloo(collective_ranks):
    """Two gloo ranks on the card: the column gather of CUDA tensors (staged
    through the host) concatenates the ranks' blocks, and its adjoint gives
    each rank its block of the summed cotangent."""
    assert all(r["staged"] and r["gather_ok"] for r in collective_ranks), collective_ranks


@pytest.mark.gpu
def test_ring_shift_adjoint_on_cuda_under_gloo(collective_ranks):
    """The ring's send/receive pair on bf16 CUDA tensors (staged through the
    host): rank r gets rank r−1's tensor (rank 0 zeros), and the gradient
    travels back along the ring (the last rank's is zero)."""
    assert all(r["staged"] and r["ring_ok"] for r in collective_ranks), collective_ranks
