"""The host-side planners that choose, before a launch, which body of a
kernel runs and how its grid is cut: K1b's and K4b's cluster body (cluster
size, rows per cluster), K2f's, K2b's and K3f's tensor-core bodies, the
query block of ``banded_flash_attention`` and K3f's, K5b's registers body.  They take the card's SM
count and shared-memory limit as arguments, so they run here without a
card; the H100's figures are 132 SMs and 227 KB (232448 bytes) of opt-in
shared memory a block.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from ecog2txt_tpu_torch.ops import attention_kernels as ak
from ecog2txt_tpu_torch.ops import layernorm_kernels as lnk
from ecog2txt_tpu_torch.ops import lstm_kernels as lk

SMS, SMEM = 132, 232448


@pytest.mark.parametrize(
    "B, H, cs, clusters",
    [(256, 400, 8, 16), (16, 400, 8, 1), (1, 400, 8, 1), (17, 100, 2, 2), (16, 64, 1, 1)],
)
def test_bf16_adjoint_runs_the_cluster_body(B, H, cs, clusters):
    """bf16 at the model's widths: the fewest CTAs a cluster whose weight
    slice fits (8 at H=400: 16 clusters of 8 CTAs at B=256; 1 at the
    demo's H=64), 16 rows a cluster, ragged B padded."""
    plan = lk.plan_bwd_body(torch.bfloat16, B, H, SMS, SMEM)
    assert plan == {"body": "cluster", "cluster_size": cs, "rows_per_cluster": 16,
                    "clusters": clusters, "smem": lk._cluster_smem(H, cs)}
    assert plan["smem"] <= SMEM


def test_cluster_slice_budget_at_the_headline_width():
    """H=400, 8 CTAs of 52 units (a multiple of 4; the last CTA owns 36):
    the partials pushed to a CTA (8 x 16 x 52 f32), the resident slice
    (400 x 216 bf16), the step's rows, the dgates slice and the pairs'
    step inputs (16 x 7 x 52) take 231040 of 232448 bytes."""
    assert lk._cluster_units(400, 8) == 52 and lk._cluster_units(100, 2) == 52
    assert lk._cluster_smem(400, 8) == (8 * 16 * 52 * 4 + 400 * 216 * 2 + 16 * 408 * 2
                                        + 16 * 216 * 2 + 16 * 7 * 52 * 2) == 231040
    assert lk._cluster_smem(64, 1) == (16 * 64 * 4 + 64 * 264 * 2 + 16 * 72 * 2
                                       + 16 * 264 * 2 + 16 * 7 * 64 * 2)


@pytest.mark.parametrize(
    "dtype, B, H, rows",
    [(torch.float32, 256, 400, 2), (torch.float32, 16, 64, 1),
     (torch.bfloat16, 256, 512, 2), (torch.bfloat16, 16, 1024, 1)],
)
def test_f32_and_wide_adjoints_keep_the_rows_body(dtype, B, H, rows):
    """f32 (no f32 tensor-core product) and widths whose slice fits no
    cluster of at most 8 CTAs keep the rows body, with its rows per block."""
    assert lk.plan_bwd_body(dtype, B, H, SMS, SMEM) == {"body": "rows", "rows_per_block": rows}


def test_cluster_body_needs_the_shared_memory():
    """Less shared memory a block pushes the plan to more CTAs a cluster,
    then to the rows body."""
    assert lk.plan_bwd_body(torch.bfloat16, 16, 100, SMS, 48 * 1024)["cluster_size"] == 4
    assert lk.plan_bwd_body(torch.bfloat16, 16, 400, SMS, 100 * 1024)["body"] == "rows"


H100_RESIDENT = {400: {8: 15}, 64: {1: 132, 2: 66, 4: 30, 8: 15}}  # clusters held at once


@pytest.mark.parametrize(
    "dtype, B, H, directions, want",
    [(torch.bfloat16, 256, 400, 1, ("cluster", 8, 32)),  # 1 wave of 8, not 2 of 15 + 1
     (torch.bfloat16, 256, 400, 2, ("cluster", 8, 16)),  # 3 waves, not 2 slower ones
     (torch.bfloat16, 1, 400, 1, ("cluster", 8, 16)),
     (torch.bfloat16, 1, 400, 2, ("cluster", 8, 16)),
     (torch.bfloat16, 17, 400, 1, ("cluster", 8, 16)),
     (torch.bfloat16, 128, 400, 1, ("cluster", 8, 16)),  # one wave either way
     (torch.bfloat16, 16, 64, 1, ("cluster", 8, 16)),  # the demo trainer: 8 CTAs of 8 units
     (torch.bfloat16, 16, 64, 2, ("cluster", 8, 16)),
     (torch.bfloat16, 1, 64, 1, ("cluster", 1, 16)),  # one real row: one CTA
     (torch.bfloat16, 256, 64, 1, ("cluster", 4, 16)),  # 16 clusters of 8 take 2 waves
     (torch.bfloat16, 256, 64, 2, ("cluster", 2, 16)),  # 32 clusters of 4 take 2 waves
     (torch.float32, 256, 400, 1, ("rows", 1)),
     (torch.float32, 256, 400, 2, ("rows", 4)),
     (torch.bfloat16, 256, 512, 1, ("rows", 1)),  # the slice fits no cluster
     (torch.bfloat16, 16, 1024, 2, ("rows", 1))],
)
def test_forward_body_plan(dtype, B, H, directions, want):
    """K1f (one direction) and K4f (two) plan the cluster body for bf16
    where a slice of ``wh`` fits: the most CTAs a cluster whose clusters
    all run at once (fewer units a CTA, fewer warps in the step's cell),
    else the fewest that fit (8 at H=400), and the fewest where B < 16;
    32 rows a cluster where that saves enough waves of the clusters the
    card keeps at once to pay for the slower 32-row wave, else 16; each
    direction has its own clusters, ``ceil(B / rows)`` of them.  f32 and
    widths whose slice fits no cluster keep the rows body (two waves of
    one-row blocks for K1f, one wave for K4f's doubled grid)."""
    resident = H100_RESIDENT.get(H)
    plan = lk.plan_fwd_body(dtype, B, H, SMS, SMEM, directions, resident)
    if want[0] == "rows":
        assert plan == {"body": "rows", "rows_per_block": want[1]}
        return
    _, cs, rows = want
    assert plan == {"body": "cluster", "cluster_size": cs, "rows_per_cluster": rows,
                    "clusters": directions * -(-B // rows),
                    "smem": lk._fwd_cluster_smem(H, cs, rows)}
    assert plan["smem"] <= SMEM
    if directions == 2:
        one = lk.plan_fwd_body(dtype, B, H, SMS, SMEM, 1, resident)
        assert one["rows_per_cluster"] != rows or plan["clusters"] == 2 * one["clusters"]


def test_forward_plan_without_a_residency_count():
    """Without the card's count the plan takes ``sms // cs`` clusters at
    once: 16 of 8 at H=400, so B=256 fits one wave of 16-row clusters."""
    plan = lk.plan_fwd_body(torch.bfloat16, 256, 400, SMS, SMEM)
    assert (plan["cluster_size"], plan["rows_per_cluster"], plan["clusters"]) == (8, 16, 16)


def test_forward_cluster_budget_at_the_headline_width():
    """H=400, 8 CTAs of 52 units: the resident slice (400 x 216 bf16) and the
    cluster's S(h·mask) rows double-buffered (2 x 16 x 408 bf16) take 198912
    bytes at 16 rows a cluster, 225024 at 32; the demo's H=64 on one CTA
    38400.  No forward cluster plan exceeds the card's 232448."""
    assert lk._fwd_cluster_smem(400, 8) == 400 * 216 * 2 + 2 * 16 * 408 * 2 == 198912
    assert lk._fwd_cluster_smem(400, 8, 32) == 400 * 216 * 2 + 2 * 32 * 408 * 2 == 225024
    assert lk._fwd_cluster_smem(64, 1) == 64 * 264 * 2 + 2 * 16 * 72 * 2 == 38400
    for H in range(8, 1025, 8):
        for directions in (1, 2):
            plan = lk.plan_fwd_body(torch.bfloat16, 256, H, SMS, SMEM, directions)
            assert plan["body"] == "rows" or plan["smem"] <= SMEM


@pytest.mark.parametrize(
    "dtype, QB, W, Dh, body",
    [(torch.bfloat16, 128, 144, 64, "tensor_core"),  # headline, request, long
     (torch.bfloat16, 128, 132, 16, "tensor_core"),  # the demo trainer
     (torch.bfloat16, 32, 48, 48, "tensor_core"),
     (torch.bfloat16, 40, 48, 96, "tensor_core"),
     (torch.bfloat16, 128, 144, 256, "tensor_core"),
     (torch.bfloat16, 128, 144, 384, "cuda_core"),  # does not fit
     (torch.float32, 128, 144, 64, "cuda_core")],
)
def test_k2f_body_by_dtype_and_shape(dtype, QB, W, Dh, body):
    assert ak.plan_k2f_body(dtype, QB, W, Dh, SMEM) == body


def test_k2f_tensor_core_block_is_smaller_than_the_f32_staging():
    """At the headline shape the bf16 block stages ~60 KB (Q, K, V padded
    to 72-element rows, the keys' chunk ids, the window's average) where
    the CUDA-core body staged 75 KB of f32 K/V alone."""
    assert ak._k2f_tc_smem(128, 144, 64) == 2 * (128 + 2 * 144) * 72 + 4 * 144 + 4 * 64 + 16
    assert ak._k2f_tc_smem(128, 144, 64) == 60752 < 2 * 144 * 65 * 4
    assert ak._k2f_tc_smem(40, 48, 20) == 2 * (48 + 2 * 48) * 40 + 4 * 48 + 4 * 32 + 16


@pytest.mark.parametrize(
    "Dh, rows", [(64, 128), (96, 128), (128, 112), (288, 32), (384, 16)],
)
def test_k3f_query_block_fits_shared_memory(Dh, rows):
    """The largest multiple of L·C (16) up to 128 rows whose K3f block fits
    227 KB with 32-column streamed tiles; head dims above 256 take 2 columns
    a thread and fit at 32 (288) and 16 (384) rows.  The LayerNorm tile
    holds only the window's rows, so head dim 128 fits 112."""
    QB = ak.plan_fused_query_rows(128, 16, 1, Dh, SMEM)
    assert QB == rows and QB % 16 == 0
    assert ak._fused_smem(QB, QB + 16, Dh) <= SMEM
    if QB < 128:
        assert ak._fused_smem(QB + 16, QB + 32, Dh) > SMEM


def test_k3f_query_block_refuses_what_no_block_fits():
    with pytest.raises(ValueError, match="head dim 640"):
        ak.plan_fused_query_rows(128, 16, 1, 640, SMEM)
    with pytest.raises(ValueError, match="no query block fits"):
        ak.plan_fused_query_rows(128, 16, 1, 384, 140 * 1024)


def test_cuda_core_attention_blocks_against_shared_memory():
    """The CUDA-core K2f/K2b blocks stage the window in f32: they fit at
    the conformer's head dim 64 and at 128, and not at 256, where the card
    refuses them (bf16 K2f runs the tensor-core body there)."""
    assert ak._cuda_core_smem("K2f", 144, 64) == 4 * (2 * 144 * 65 + 8 * (64 + 144))
    assert ak._cuda_core_smem("K2b-dkv", 144, 64) == 4 * (2 * 144 * 65 + 2 * 144
                                                          + 8 * (2 * 64 + 2 * 144))
    for kernel in ("K2f", "K2b-dq", "K2b-dkv"):
        assert ak._cuda_core_smem(kernel, 144, 128) <= SMEM
        assert ak._cuda_core_smem(kernel, 144, 256) > SMEM


@pytest.mark.parametrize(
    "dtype, B, H, plan",
    [(torch.bfloat16, 256, 400, {"body": "cluster", "cluster_size": 8, "rows_per_cluster": 16,
                                 "clusters": 32, "smem": 231040}),
     (torch.bfloat16, 1, 400, {"body": "cluster", "cluster_size": 8, "rows_per_cluster": 16,
                               "clusters": 2, "smem": 231040}),
     (torch.float32, 256, 400, {"body": "rows", "rows_per_block": 4}),
     (torch.bfloat16, 256, 512, {"body": "rows", "rows_per_block": 4})],
)
def test_k4b_plans_two_directions(dtype, B, H, plan):
    """K4b runs both chains of a layer in one launch: bf16 at H=400 takes
    the cluster body with twice K1b's clusters (32 of 8 CTAs at B=256);
    f32, and H=512 whose slice fits no cluster, keep the rows body with
    the rows per block of a doubled grid."""
    assert lk.plan_bwd_body(dtype, B, H, SMS, SMEM, directions=2) == plan
    if plan["body"] == "rows":
        assert plan["rows_per_block"] == lk._rows_for(B, H, SMS, directions=2)


@pytest.mark.parametrize(
    "dtype, QB, W, Dh, body",
    [(torch.bfloat16, 128, 144, 64, "tensor_core"),  # headline, request, long
     (torch.bfloat16, 128, 132, 16, "tensor_core"),  # the demo trainer
     (torch.bfloat16, 96, 112, 256, "tensor_core"),  # head dim 256, planned block
     (torch.bfloat16, 128, 144, 256, "cuda_core"),   # does not fit
     (torch.float32, 128, 144, 64, "cuda_core"),
     (torch.float32, 128, 132, 16, "cuda_core")],
)
def test_k2b_body_by_dtype_and_shape(dtype, QB, W, Dh, body):
    assert ak.plan_k2b_body(dtype, QB, W, Dh, SMEM) == body


def test_k2b_tensor_core_blocks_at_the_headline_shape():
    """K2b-dq stages Q and G (128 rows) and K and V (144) in bf16 at a
    72-element row stride, and 144 key chunk ids: 78912 bytes; K2b-dkv
    K and V (128) and Q and G (144), with chunk ids, lse and delta of the
    144 rows: 80064 bytes.  Two blocks fit an SM."""
    assert ak._k2b_tc_smem("K2b-dq", 128, 144, 64) == 2 * (256 + 288) * 72 + 4 * 144 == 78912
    assert ak._k2b_tc_smem("K2b-dkv", 128, 144, 64) == 2 * (256 + 288) * 72 + 12 * 144 == 80064
    assert ak._k2b_tc_smem("K2b-dkv", 40, 48, 20) == 2 * (2 * 48 + 2 * 48) * 40 + 12 * 48


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_query_block_keeps_128_rows_at_the_conformer_head_dim(dtype):
    assert ak.plan_banded_query_rows(dtype, 128, 16, 1, 64, SMEM) == 128
    assert ak.plan_banded_query_rows(dtype, 128, 4, 1, 16, SMEM) == 128  # the demo trainer


@pytest.mark.parametrize("dtype, rows", [(torch.float32, 80), (torch.bfloat16, 96)])
def test_banded_query_block_shrinks_at_head_dim_256(dtype, rows):
    """Head dim 256 (``model_dim=256, num_heads=1``): the largest multiple
    of L·C = 16 whose blocks fit every body that runs them, the CUDA-core
    bodies' f32 window (f32) or the tensor-core bodies (bf16); 16 more rows
    would not fit."""
    QB = ak.plan_banded_query_rows(dtype, 128, 16, 1, 256, SMEM)
    assert QB == rows and QB % 16 == 0
    for q in (QB, QB + 16):
        fits = (ak._k2f_tc_smem(q, q + 16, 256) <= SMEM
                and all(ak._k2b_tc_smem(k, q, q + 16, 256) <= SMEM for k in ("K2b-dq", "K2b-dkv"))
                if dtype == torch.bfloat16 else
                all(ak._cuda_core_smem(k, q + 16, 256) <= SMEM
                    for k in ("K2f", "K2b-dq", "K2b-dkv")))
        assert fits == (q == QB)
    if dtype == torch.bfloat16:
        assert ak.plan_k2f_body(dtype, QB, QB + 16, 256, SMEM) == "tensor_core"
        assert ak.plan_k2b_body(dtype, QB, QB + 16, 256, SMEM) == "tensor_core"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_query_block_refuses_what_no_block_fits(dtype):
    with pytest.raises(ValueError, match="head dim 256, chunk 16, left context 1"):
        ak.plan_banded_query_rows(dtype, 128, 16, 1, 256, 40 * 1024)


@pytest.mark.parametrize("C, Dh, rows", [(16, 448, 16), (4, 512, 20)])
def test_k3f_query_block_at_its_widest_head_dims(C, Dh, rows):
    """K3f stages q, k and v of the window in f32 at the full head dim, plus
    the streamed LayerNorm and weight tiles: at chunk 16, left context 1 one
    16-row block fits head dim 448; at chunk 4 head dim 512 fits 20 rows
    (the LayerNorm tile holds the window's 24 rows, not 192)."""
    assert ak.plan_fused_query_rows(128, C, 1, Dh, SMEM) == rows


@pytest.mark.parametrize("Dh", [454, 456, 512])
def test_k3f_refuses_wide_heads_at_chunk_16(Dh):
    """These head dims were once refused at chunk 16, left context 1 (not
    even 16 rows of K3f's f32 staging fitted).  Now the CUDA-core body (f32
    streams; it stages in f32) plans a 16-row block for each: the LayerNorm
    tile sized by the window's 32 rows brings 454 and 456 in with 32-column
    tiles, and 512 fits with 16-column tiles (a 32-column weight tile of 64
    KB would not).  bf16 plans the tensor-core body (below)."""
    tile = 16 if Dh == 512 else 32
    assert ak.plan_fused_query_rows(128, 16, 1, Dh, SMEM) == 16
    assert ak._fused_tile(16, 32, Dh, SMEM) == tile
    assert ak._fused_smem(16, 32, Dh, tile) <= SMEM
    if tile == 16:
        assert ak._fused_smem(16, 32, Dh, 32) > SMEM


def test_flash_attention_values_do_not_depend_on_the_query_block():
    """``banded_flash_attention`` on the CPU (the plain versions) at query
    blocks of 32 and 128 rows, head dim 64, ragged lengths: the outputs on
    rows below each length, and the gradients of q, k and v (a cotangent
    on every row), agree at the f32 tolerance.  The band, not the block,
    defines what a row sees, so the block the card plans changes nothing
    the JAX function's block defines."""
    B, T, H, Dh, C, L = 2, 100, 2, 64, 16, 1
    rng = np.random.default_rng(0)
    q, k, v, cot = (torch.from_numpy(rng.standard_normal((B, T, H, Dh), dtype=np.float32))
                    for _ in range(4))
    lengths = torch.tensor([100, 61], dtype=torch.int32)

    def run(rows):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        out = ak.banded_flash_attention(*leaves, 0, lengths, chunk_size=C, left_context=L,
                                        query_rows=rows)
        (out * cot).sum().backward()
        return out.detach(), [a.grad for a in leaves]

    (o32, g32), (o128, g128) = run(32), run(None)
    valid = (torch.arange(T)[None] < lengths[:, None])[..., None, None]
    tol = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(torch.where(valid, o32, 0.0), torch.where(valid, o128, 0.0), **tol)
    for a, b in zip(g32, g128):
        torch.testing.assert_close(a, b, **tol)


def test_lstm_width_limit_is_the_kernels_alone():
    """The CUDA kernels refuse H > 1024 (one thread a hidden unit); the
    plain path on a CPU tensor takes any width, as JAX does."""
    T, B, Hw = 2, 1, 1040
    g = torch.Generator().manual_seed(0)
    xw = torch.randn((T, B, 4 * Hw), generator=g)
    wh = torch.randn((Hw, 4 * Hw), generator=g) / Hw ** 0.5
    zeros = torch.zeros((B, Hw))
    lengths = torch.tensor([T], dtype=torch.int32)
    h_seq, _, hT, _ = lk.lstm_recurrence(xw, wh, lengths, zeros, zeros, torch.ones((B, Hw)))
    assert h_seq.shape == (T, B, Hw) and bool(torch.isfinite(hT).all())
    with pytest.raises(ValueError, match="H=1040 is above the CUDA kernels' limit H <= 1024"):
        lk._check_kernel_width("lstm_recurrence", Hw)
    lk._check_kernel_width("lstm_recurrence", 1024)


def test_concurrent_loads_build_a_library_once(tmp_path, monkeypatch):
    """``_build.load_library`` asked for one library by many threads at once
    (as ``chip_smoke.py`` builds every source while the LSTM phases load
    theirs) compiles it once and hands every thread the loaded library."""
    import sys
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from ecog2txt_tpu_torch.ops import _build

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fake.cu").write_text("// a kernel source\n")
    calls = []

    def fake_compile(source, out):
        calls.append(source.name)
        time.sleep(0.05)  # every other thread arrives while this one builds
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("built")

    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    _build.load_library.cache_clear()
    try:
        barrier = threading.Barrier(16)

        def load(_):
            barrier.wait(timeout=10)
            return _build.load_library("fake")

        with ThreadPoolExecutor(16) as pool:
            results = list(pool.map(load, range(16), timeout=30))
    finally:
        sys.setswitchinterval(old_interval)
        _build.load_library.cache_clear()
    assert calls == ["fake.cu"]
    assert len(set(results)) == 1 and results[0][0] == "loaded"


def test_k3f_tensor_core_block_at_the_headline_shape():
    """The bf16 block at QB=128, window 144, head dim 64: the tiles of the
    normalised rows (2 x 144 rows x 72) and the slices of Wq, Wk, Wv (2 x 3 x
    64 x 72), q (128 rows) and k, v (144) at a 72-element stride, all bf16;
    the keys' chunk ids, the window's average and a flag: 157520 bytes, one
    block an SM, with room for the rotary table's slice (144 x 64 pairs)."""
    assert ak._fused_tc_smem(128, 144, 64) == (2 * (2 * 144 * 72 + 6 * 64 * 72 + 416 * 72)
                                               + 4 * (144 + 64) + 16) == 157520
    assert 157520 + 144 * 64 * 4 <= SMEM < 2 * 157520
    # q rows past the window's padded rows: the tiles cover L·C + QBp rows
    assert ak._fused_tc_smem(20, 24, 48) == (2 * (2 * 48 * 72 + 6 * 64 * 72 + (32 + 64) * 56)
                                             + 4 * (32 + 48) + 16)


@pytest.mark.parametrize(
    "dtype, QB, W, Dh, body",
    [(torch.bfloat16, 128, 144, 64, "tensor_core"),  # headline, B=256
     (torch.bfloat16, 32, 48, 64, "tensor_core"),  # a B=1 request
     (torch.bfloat16, 32, 48, 454, "tensor_core"),
     (torch.bfloat16, 32, 48, 512, "tensor_core"),
     (torch.bfloat16, 128, 144, 512, "cuda_core"),  # does not fit
     (torch.bfloat16, 16, 32, 514, "cuda_core"),  # above the kernels' 512
     (torch.float32, 128, 144, 64, "cuda_core"),
     (torch.float32, 16, 32, 454, "cuda_core")],
)
def test_k3f_body_by_dtype_and_shape(dtype, QB, W, Dh, body):
    assert ak.plan_k3f_body(dtype, QB, W, Dh, SMEM) == body


@pytest.mark.parametrize(
    "B, T, H, Dh, rows",
    [(256, 104, 6, 64, 128),  # 1536 blocks of 128 rows fill the card
     (1, 104, 6, 64, 32),  # a B=1 request: 6 blocks of 128 rows would idle 126 SMs
     (17, 104, 6, 64, 32),
     (16, 8192, 6, 64, 128),  # the long recording
     (256, 104, 1, 454, 32), (256, 104, 1, 512, 32),  # the widest that fits
     (256, 104, 1, 288, 64)],
)
def test_k3f_query_block_by_batch(B, T, H, Dh, rows):
    """bf16: the largest multiple of L·C up to 128 whose tensor-core block
    fits, or 32 rows where that block's grid has fewer blocks than the
    card's 132 SMs."""
    assert ak.plan_fused_layer(torch.bfloat16, B, T, H, 128, 16, 1, Dh, SMEM, SMS) == (
        rows, "tensor_core")
    assert ak._fused_tc_smem(rows, rows + 16, Dh) <= SMEM


def test_every_even_head_dim_to_512_gets_a_k3f_plan():
    """At chunk 16, left context 1 every even head dim up to 512 plans a
    block: bf16 on the tensor cores, f32 on the CUDA cores (its own block)."""
    for Dh in range(2, 513, 2):
        rows, body = ak.plan_fused_layer(torch.bfloat16, 256, 104, 1, 128, 16, 1, Dh, SMEM, SMS)
        assert body == "tensor_core" and rows % 16 == 0
        assert ak.plan_k3f_body(torch.bfloat16, rows, rows + 16, Dh, SMEM) == "tensor_core"
        f32 = ak.plan_fused_layer(torch.float32, 256, 104, 1, 128, 16, 1, Dh, SMEM, SMS)
        assert f32 == (ak.plan_fused_query_rows(128, 16, 1, Dh, SMEM), "cuda_core")


def test_k3f_plan_takes_the_cuda_core_body_where_no_tensor_core_block_fits():
    """With too little shared memory for even 16 rows on the tensor cores,
    bf16 plans the CUDA-core body at its own block; f32 plans it always."""
    tight = ak._fused_tc_smem(16, 32, 64) - 1
    assert ak._fused_smem(16, 32, 64, 32) <= tight
    assert ak.plan_fused_layer(torch.bfloat16, 256, 104, 6, 128, 16, 1, 64, tight, SMS) == (
        ak.plan_fused_query_rows(128, 16, 1, 64, tight), "cuda_core")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D, H", [(64, 4), (384, 6), (96, 2), (100, 2)])
def test_rotary_product_is_a_signed_permutation_of_the_plain_product(dtype, D, H):
    """K3f's tensor-core body forms ``S(lnx·(W@R))`` from ``S(lnx·W)``
    instead of a second product: on the port's plain path the two agree bit
    for bit (negation commutes with the f32 sums and the rounding)."""
    rng = np.random.default_rng(D)
    lnx = torch.from_numpy(rng.standard_normal((2, 24, D), dtype=np.float32)).to(dtype)
    wqkv = torch.from_numpy(rng.standard_normal((D, 3 * D), dtype=np.float32)) / D ** 0.5
    wq, wqr, wk, wkr, _ = ak._split_rot_weights(wqkv, H, dtype)
    mm = lambda w: (lnx.float() @ w.float()).to(dtype)  # noqa: E731
    assert torch.equal(mm(wqr), ak._rot_half(mm(wq), H))
    assert torch.equal(mm(wkr), ak._rot_half(mm(wk), H))


@pytest.mark.parametrize(
    "dtype, D, vec, body",
    [(torch.bfloat16, 384, True, "registers"),  # the conformer's width, 2 chunks a lane
     (torch.bfloat16, 64, True, "registers"),  # the demo's
     (torch.bfloat16, 1024, True, "registers"),
     (torch.bfloat16, 1032, True, "columns"),
     (torch.bfloat16, 100, False, "registers"),  # 200-byte rows: single elements
     (torch.bfloat16, 384, False, "columns"),  # unaligned: 12 elements a lane
     (torch.float32, 100, True, "registers"),
     (torch.float32, 512, True, "registers"),
     (torch.float32, 1024, True, "columns"),
     (torch.float32, 37, False, "registers")],
)
def test_k5b_body_by_width(dtype, D, vec, body):
    """K5b's registers body takes a row whose lanes hold at most four chunks
    (16-byte vectors, else single elements); wider rows run the columns
    body."""
    assert lnk.plan_k5b_body(dtype, D, vec) == body
