"""The port's FLOP counts and step timing.

``ecog2txt_tpu_torch.utils.flops`` against ``ecog2txt_tpu.utils.flops``
for the biLSTM (the JAX benchmark's configuration and a unidirectional
attention variant), the headline conformer, the MoE conformer and the
long recording's encoder: equal counts (the same float arithmetic), and
MFU against the H100's dense bf16 peak.  ``StepTimer`` on the CPU clock;
``force_result``; ``trace_to`` writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu.utils import flops as jflops
from ecog2txt_tpu_torch.models import conformer as tc
from ecog2txt_tpu_torch.models import seq2seq as ts
from ecog2txt_tpu_torch.utils import flops as tflops
from ecog2txt_tpu_torch.utils.profiling import StepTimer, force_result, trace_to
from torch_threads import one_torch_thread  # noqa: F401

HEADLINE = dict(num_blocks=4, model_dim=384, num_heads=6, ffn_dim=1536, conv_kernel=8,
                chunk_size=16, left_context=1)
MOE = {**HEADLINE, "moe_experts": 8, "moe_topk": 2, "moe_capacity_factor": 1.25,
       "moe_group_size": 512}
BENCH = dict(vocab_size=1809, num_subjects=1, in_channels=469, conv_sizes=(100,),
             decimation_factor=12, rnn_sizes=(400, 400, 400), aux_proj_sizes=(225,),
             dec_embedding_size=150, dec_rnn_sizes=(800,), max_dec_len=20)


def _pair(conformer=None, aux=True, **extra):
    jheads = (js.AuxHead("encoder_1_targets", "categorical", 40),) if aux else ()
    theads = (ts.AuxHead("encoder_1_targets", "categorical", 40),) if aux else ()
    kw = {**BENCH, **extra}
    if conformer is not None:
        kw["encoder_type"] = "conformer"
    return (js.Seq2SeqConfig(**kw, aux_heads=jheads,
                             conformer=jc.ConformerConfig(**conformer) if conformer else None),
            ts.Seq2SeqConfig(**kw, aux_heads=theads,
                             conformer=tc.ConformerConfig(**conformer) if conformer else None))


@pytest.mark.parametrize("case", ["bilstm", "bilstm_attention", "conformer", "moe", "no_conv"])
def test_flop_counts_equal_jax(case):
    extra = {"bilstm": {}, "bilstm_attention": {"use_attention": True, "BIDIRECTIONAL": False},
             "conformer": {"conformer": HEADLINE}, "moe": {"conformer": MOE},
             "no_conv": {"conv_sizes": (), "conformer": HEADLINE}}[case]
    jcfg, tcfg = _pair(**extra)
    for T, dec in ((1248, None), (1000, 7)):
        assert tflops.seq2seq_forward_flops(tcfg, T, dec) == jflops.seq2seq_forward_flops(jcfg, T, dec)
        assert tflops.train_step_flops(tcfg, T, dec) == jflops.train_step_flops(jcfg, T, dec)


def test_encoder_flops_per_step_and_mfu():
    for conf, t in ((HEADLINE, None), (HEADLINE, 8192), (MOE, 2048)):
        assert tflops.conformer_encoder_forward_flops_per_step(tc.ConformerConfig(**conf), 100, t) \
            == jflops.conformer_encoder_forward_flops_per_step(jc.ConformerConfig(**conf), 100, t)
    assert tflops.H100_BF16_PEAK_FLOPS == 989e12
    assert tflops.mfu(1000.0, 989e9) == pytest.approx(1.0)
    assert tflops.mfu(10.0, 1e12, peak_flops=1e13) == jflops.mfu(10.0, 1e12, peak_flops=1e13)


def test_step_timer_on_the_cpu():
    timer = StepTimer()
    with pytest.raises(RuntimeError, match="start"):
        timer.lap()
    timer.start()
    x = torch.ones(64, 64)
    for _ in range(3):
        y = x @ x
        assert timer.lap(items=4, result=y) >= 0.0
    s = timer.summary()
    assert s["laps"] == 3 and timer.total_items == 12
    assert s["total_s"] == pytest.approx(sum(d for d, _ in timer.laps))
    assert s["items_per_second"] == pytest.approx(12 / s["total_s"])
    assert force_result({"a": torch.full((2,), 1.5)}) == 3.0
    assert force_result([]) == 0.0
    assert StepTimer().summary()["items_per_second"] == 0.0


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(str(tmp_path / "trace")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    path = tmp_path / "trace" / "trace.json"
    assert path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert os.path.getsize(path) > 0 and np.isfinite(len(events))
