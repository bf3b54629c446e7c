"""The port's tensor and pipeline parallelism in one process, held to the
JAX package.

What needs no second process: the tensor-parallel leaf rule against the
specs JAX's ``shard_params_tp`` places on the 8-device CPU mesh (the
biLSTM and the conformer cases of ``tests/test_parallel.py``) and the
column block a rank keeps; ``stack_block_params`` against JAX's; the
pipeline meshes, rank r where the JAX trainer puts device r; and the
refusals, with JAX's exception type: tp × ep and pp without the conformer
in both trainers, a batch that does not split into the microbatches and a
microbatch that does not split over the data axis.  Tolerances: exact
(placement and stacking move values only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu import demo as jdemo
from ecog2txt_tpu import train as jtrain
from ecog2txt_tpu.models import Seq2SeqConfig as JaxSeq2SeqConfig
from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import init_seq2seq as jax_init_seq2seq
from ecog2txt_tpu.parallel import make_mesh as jax_make_mesh
from ecog2txt_tpu.parallel import pipeline as jpipe
from ecog2txt_tpu.parallel import shard_params_tp as jax_shard_params_tp
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, params_to_numpy, tree_leaves
from ecog2txt_tpu_torch.models import conformer as tc
from ecog2txt_tpu_torch.models.seq2seq import Seq2SeqConfig, init_seq2seq
from ecog2txt_tpu_torch.parallel import pipeline as tpipe
from ecog2txt_tpu_torch.parallel.mesh import (
    Placement,
    mesh_axes,
    mesh_layout,
    shard_params_tp,
    tp_mask,
)
from ecog2txt_tpu_torch.parallel.multihost import map_with_path
from torch_threads import one_torch_thread  # noqa: F401

# the configurations of tests/test_parallel.py's tp cases
SEQ = dict(vocab_size=64, num_subjects=1, in_channels=8, conv_sizes=(16,),
           decimation_factor=4, rnn_sizes=(16,), aux_proj_sizes=(8,),
           dec_embedding_size=8, dec_rnn_sizes=(32,), max_dec_len=4)
CONFORMER = dict(num_blocks=1, model_dim=64, num_heads=2, ffn_dim=128, conv_kernel=4,
                 chunk_size=4, left_context=1)
TINY = {"encoder_embedding": [16], "encoder_rnn": [24], "encoder_1_projection": [16],
        "decoder_embedding": [12], "decoder_rnn": [48], "decoder_projection": []}
SMALL_CONFORMER = dict(num_blocks=2, model_dim=16, num_heads=2, ffn_dim=32, conv_kernel=4,
                       chunk_size=4, left_context=1)


class Rank:
    """Rank ``coords`` of a mesh of ``shape``, for the placement functions."""

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def coord(self, axis):
        return self.coords[axis]


def _configs(family):
    if family == "lstm":
        return JaxSeq2SeqConfig(**SEQ), Seq2SeqConfig(**SEQ)
    return (JaxSeq2SeqConfig(**SEQ, encoder_type="conformer",
                             conformer=jc.ConformerConfig(**CONFORMER)),
            Seq2SeqConfig(**SEQ, encoder_type="conformer",
                          conformer=tc.ConformerConfig(**CONFORMER)))


def _slash(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("family", ["lstm", "conformer"])
def test_tp_placement_matches_jax_shard_params_tp(family):
    """Leaf by leaf, the port splits the leaves whose last dim JAX's
    ``shard_params_tp`` places on 'model' of a (data=4, model=2) mesh (the
    LSTM gate kernels, the vocab projection, the conformer conv module's
    pointwise kernels; not the subsample conv), and rank 1 of the axis keeps
    the second half of their columns and every other leaf whole."""
    jcfg, tcfg = _configs(family)
    jparams = jax_shard_params_tp(jax_init_seq2seq(jax.random.PRNGKey(0), jcfg),
                                  jax_make_mesh(n_data=4, n_model=2))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = {_slash(p) for p, leaf in flat if leaf.sharding.spec and
            leaf.sharding.spec[-1] == "model"}
    assert {_slash(p) for p, leaf in flat if any(s is not None for s in leaf.sharding.spec)} \
        == want
    tree = params_to_numpy(init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu"))
    got = set()
    map_with_path(lambda p, m: got.add("/".join(map(str, p))) if m else None,
                  tp_mask(params_from_numpy(tree, "cpu"), 2))
    assert got == want
    assert "subnet/conv/0/w" not in got
    assert ("decoder/out/w" in got and (family == "lstm") ==
            ("encoder/rnn/0/fwd/wh" in got))
    if family == "conformer":
        assert "encoder/conformer/blocks/0/conv/pw1" in got
    placed = shard_params_tp(params_from_numpy(tree, "cpu"),
                             Rank({"data": 1, "model": 2}, {"data": 0, "model": 1}))

    def check(path, leaf):
        node = placed
        for k in path:
            node = node[k]
        if "/".join(map(str, path)) in want:
            np.testing.assert_array_equal(node.numpy(), leaf[..., leaf.shape[-1] // 2:])
        else:
            np.testing.assert_array_equal(node.numpy(), leaf)

    map_with_path(check, tree)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_stack_block_params_matches_jax(stages):
    """The stacked stage tree equals JAX's, leaf by leaf; the stage cut of
    ``shard_stages`` is stage s's row of it; 4 blocks do not split into 3
    stages in either package."""
    cfg = dict(SMALL_CONFORMER, num_blocks=4)
    tree = params_to_numpy(tc.init_conformer(torch.Generator().manual_seed(0),
                                             tc.ConformerConfig(**cfg), 6, "cpu"))
    want = jpipe.stack_block_params(jax.tree.map(jnp.asarray, tree), stages)
    got = tpipe.stack_block_params(params_from_numpy(tree, "cpu"), stages)
    for g, w in zip(jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    for s in range(stages):
        cut = tpipe.shard_stages(params_from_numpy(tree, "cpu"),
                                 Rank({"pp": stages}, {"pp": s}), "pp")
        for j, block in enumerate(cut["blocks"]):
            for g, w in zip(tree_leaves(block), tree_leaves(got)):
                np.testing.assert_array_equal(g.numpy(), w[s, j].numpy())
    with pytest.raises(ValueError, match="do not split"):
        jpipe.stack_block_params(tree, 3)
    with pytest.raises(ValueError, match="do not split"):
        tpipe.stack_block_params(params_from_numpy(tree, "cpu"), 3)


@pytest.mark.parametrize("sn", [
    {"pipeline_parallel": 2, "data_parallel": True},
    {"pipeline_parallel": 2, "tensor_parallel": 2, "data_parallel": True},
    {"pipeline_parallel": 2, "sequence_parallel": 2, "data_parallel": True},
    {"pipeline_parallel": 2, "sequence_parallel": 2, "tensor_parallel": 2},
], ids=["data_pp", "data_pp_model", "data_seq_pp", "data_seq_pp_model"])
def test_pipeline_meshes_match_the_jax_trainer(tmp_path, sn):
    """The JAX trainer's pipeline meshes on the 8 CPU devices: the port lays
    its ranks out on the same axes, rank r where device r sits."""
    manifest = jdemo.make_demo_experiment(str(tmp_path / "exp"), subject_ids=(1,),
                                          layer_sizes=TINY, N_epochs=1)
    trainer = jtrain.MultiSubjectTrainer(
        manifest, [1], VERBOSE=False,
        SN_kwargs={**sn, "encoder_type": "conformer", "conformer": SMALL_CONFORMER})
    mesh = trainer.mesh
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    size = dict(mesh.shape)
    n_model = size.get("model", 1)
    assert tuple(mesh.axis_names) == mesh_axes(n_model, size.get("seq", 1), size["pp"])
    np.testing.assert_array_equal(
        mesh_layout(size["data"], n_model, size.get("seq", 1), size["pp"]), ids)


def test_refusals_match_jax(tmp_path):
    """tp × ep and pp without the conformer raise ``ValueError`` in both
    trainers, and tp × ep in JAX's pipeline and the port's placement; a
    batch that does not split into the microbatches and a microbatch that
    does not split over the data axis raise ``ValueError`` in both
    pipelines (checked before any communication)."""
    jm = jdemo.make_demo_experiment(str(tmp_path / "jax"), subject_ids=(1,),
                                    layer_sizes=TINY, N_epochs=1)
    tm = tdemo.make_demo_experiment(str(tmp_path / "port"), subject_ids=(1,),
                                    layer_sizes=TINY, N_epochs=1)
    moe = {"encoder_type": "conformer",
           "conformer": {**SMALL_CONFORMER, "moe_experts": 4, "moe_topk": 2}}
    for sn, match in (({**moe, "tensor_parallel": 2, "expert_parallel": 2},
                       "tensor_parallel × expert_parallel"),
                      ({"pipeline_parallel": 2}, "requires encoder_type='conformer'")):
        with pytest.raises(ValueError, match=match):
            jtrain.MultiSubjectTrainer(jm, [1], SN_kwargs=sn, VERBOSE=False)
        with pytest.raises(ValueError, match=match):
            ttrain.MultiSubjectTrainer(tm, [1], SN_kwargs=sn, VERBOSE=False, device="cpu")
    cfg = dict(SMALL_CONFORMER, num_blocks=2)
    jparams = jc.init_conformer(jax.random.PRNGKey(0), jc.ConformerConfig(**cfg), 6)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "pp"))
    tparams = tc.init_conformer(torch.Generator().manual_seed(0), tc.ConformerConfig(**cfg), 6,
                                "cpu")
    rank = Rank({"data": 2, "pp": 2}, {"data": 0, "pp": 0})
    for B, M, match in ((3, 2, "does not split into 2 microbatches"),
                        (4, 4, "does not shard over data axis")):
        with pytest.raises(ValueError, match=match):
            jpipe.pipeline_conformer_encode(jparams, jc.ConformerConfig(**cfg),
                                            jnp.zeros((B, 16, 6)), jmesh, microbatches=M)
        with pytest.raises(ValueError, match=match):
            tpipe.check_microbatches(B, M, 2)
    with pytest.raises(ValueError, match="does not split into 2 microbatches"):
        tpipe.pipeline_conformer_encode(tparams, tc.ConformerConfig(**cfg),
                                        torch.zeros((3, 16, 6)), rank, microbatches=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jpipe.pipeline_conformer_encode(jparams, jc.ConformerConfig(**cfg),
                                        jnp.zeros((4, 16, 6)), jmesh, ep_axis="data",
                                        tp_axis="data")
    with pytest.raises(ValueError, match="mutually exclusive"):
        Placement(Rank({"data": 1, "model": 2}, {"data": 0, "model": 0}), tparams, tp=True,
                  experts=4)
