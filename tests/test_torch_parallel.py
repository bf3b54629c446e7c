"""The port's parallel modules in one process, held to the JAX package.

What needs no second process: the mesh layout (rank r where JAX's
``make_mesh`` puts device r), the expert-parallel leaf rule (``ep_spec``
picks the leaves JAX's does) and its placement on a mesh, ``halo_steps``,
the sequence-parallel shard body run shard by shard (each shard's input
tail fed to the next, the router statistics summed over the shards)
against JAX's ``sequence_parallel_encode`` on n = 2 and 4 devices (dense
and capacity MoE, f32), the refusals of shards that do not align (the
JAX package's ``ValueError`` conditions, both packages raising), the
backend choice, and the trainer's checks of the tensor- and
pipeline-parallel keys.  Tolerances: f32 rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.parallel import expert as jexpert
from ecog2txt_tpu.parallel import make_mesh as jax_make_mesh
from ecog2txt_tpu.parallel import sequence as jseq
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, params_to_numpy
from ecog2txt_tpu_torch.models import conformer as tc
from ecog2txt_tpu_torch.parallel import expert as texpert
from ecog2txt_tpu_torch.parallel import sequence as tseq
from ecog2txt_tpu_torch.parallel.mesh import mesh_layout
from ecog2txt_tpu_torch.parallel.multihost import default_backend, map_with_path
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
CFG = dict(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64, conv_kernel=4,
           chunk_size=4, left_context=1)
MOE = {**CFG, "moe_experts": 4, "moe_topk": 2}
CAPACITY = {**MOE, "moe_capacity_factor": 1.25, "moe_group_size": 8}
B, T, IN = 2, 64, 6
LENGTHS = np.array([64, 41], np.int32)


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2), (1, 1, 4)])
def test_mesh_layout_matches_jax(shape):
    """Rank r sits at the coordinates device r has in JAX's mesh."""
    n_data, n_model, n_seq = shape
    n = n_data * n_model * n_seq
    jmesh = jax_make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq,
                          devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(mesh_layout(n_data, n_model, n_seq), ids)


def _slash(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("conformer", [CFG, MOE])
def test_ep_spec_picks_jax_leaves_and_shards_them(conformer):
    """The expert leaves (``w1``, ``b1``, ``w2``, ``b2`` under each block's
    MoE ``ffn2``) are JAX's; a rank keeps its block of E on dim 0 and every
    other leaf whole."""
    cfg = tc.ConformerConfig(**conformer)
    tree = params_to_numpy(tc.init_conformer(torch.Generator().manual_seed(0), cfg, 8, "cpu"))
    E = conformer.get("moe_experts", 0) or 4
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = {_slash(p) for p, leaf in flat if jexpert.ep_spec(p, leaf, E, "model") is not None
            and jexpert.ep_spec(p, leaf, E, "model") != jax.sharding.PartitionSpec()}
    got = set()
    map_with_path(lambda p, leaf: got.add("/".join(map(str, p)))
                  if texpert.ep_spec(p, leaf, E, "model") else None, tree)
    assert got == want
    assert bool(got) == bool(conformer.get("moe_experts"))

    class TwoRanks:  # rank 1 of a model axis of 2
        shape, coords = {"data": 1, "model": 2}, {"data": 0, "model": 1}

        def coord(self, axis):
            return self.coords[axis]

    placed = texpert.shard_params_ep(params_from_numpy(tree, "cpu"), TwoRanks(), E)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = placed
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        if _slash(path) in want:
            np.testing.assert_array_equal(node.numpy(), leaf[E // 2:])
        else:
            np.testing.assert_array_equal(node.numpy(), leaf)
    with pytest.raises(ValueError, match="must divide evenly"):
        texpert.shard_params_ep(params_from_numpy(tree, "cpu"), TwoRanks(), 3)


@pytest.mark.parametrize("kw", [CFG, {**CFG, "num_blocks": 3, "conv_kernel": 9},
                                {**CFG, "chunk_size": 16, "left_context": 2}])
def test_halo_steps_match_jax(kw):
    assert tseq.halo_steps(tc.ConformerConfig(**kw)) == jseq.halo_steps(jc.ConformerConfig(**kw))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, IN)).astype(np.float32)


def _port_shards(tree, cfg, xs, n):
    """The shard body on each shard in turn: shard k gets shard k-1's input
    tail (zeros for the first), its statistics count its own span."""
    params = params_from_numpy(tree, "cpu")
    S, halo = tseq.check_shards(cfg, T, n)
    x = torch.from_numpy(xs)
    lengths = torch.from_numpy(LENGTHS).long()
    outs, stats = [], None
    for k in range(n):
        tail = x[:, k * S - halo:k * S] if k else torch.zeros(B, halo, IN)
        out, st = tseq.encode_shard(params, cfg, x[:, k * S:(k + 1) * S], tail, k * S, lengths)
        outs.append(out)
        if cfg.moe_experts:
            stats = st if stats is None else [
                {key: a[key] + b[key] for key in a} for a, b in zip(stats, st)]
    out = torch.cat(outs, dim=1)
    aux = tc.moe_aux_from_stats(cfg, stats) if cfg.moe_experts else None
    return out, aux


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "capacity"])
def test_shard_body_matches_jax_sequence_parallel_encode(n, kind):
    """The shards' outputs concatenated, and the MoE aux from the summed
    statistics, equal JAX's ``sequence_parallel_encode`` on n devices."""
    conformer = CFG if kind == "dense" else CAPACITY
    tcfg, jcfg = tc.ConformerConfig(**conformer), jc.ConformerConfig(**conformer)
    tree = params_to_numpy(tc.init_conformer(torch.Generator().manual_seed(1), tcfg, IN, "cpu"))
    xs = _inputs()
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    want = jax.jit(lambda p, x, lens: jseq.sequence_parallel_encode(
        p, jcfg, x, mesh, lengths=lens, return_aux=bool(jcfg.moe_experts)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(xs), jnp.asarray(LENGTHS))
    got, aux = _port_shards(tree, tcfg, xs, n)
    if jcfg.moe_experts:
        want, want_aux = want
        np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("conformer,steps,n,match", [
    (CFG, 60, 2, "multiple of n·chunk_size"),
    (CFG, 48, 4, "per-shard steps 12 < halo 16"),
    ({**MOE, "moe_capacity_factor": 1.25}, 64, 2, "shard-aligned dispatch groups"),
    ({**MOE, "moe_capacity_factor": 1.25, "moe_group_size": 12}, 64, 2,
     "shard-aligned dispatch groups"),
])
def test_misaligned_shards_refused_as_jax(conformer, steps, n, match):
    with pytest.raises(ValueError, match=match):
        tseq.check_shards(tc.ConformerConfig(**conformer), steps, n)
    jcfg = jc.ConformerConfig(**conformer)
    tree = params_to_numpy(tc.init_conformer(torch.Generator().manual_seed(1),
                                             tc.ConformerConfig(**conformer), IN, "cpu"))
    with pytest.raises(ValueError):
        jseq.sequence_parallel_encode(
            jax.tree.map(jnp.asarray, tree), jcfg, jnp.zeros((1, steps, IN)),
            Mesh(np.array(jax.devices()[:n]), ("seq",)))


def test_backend_is_chosen_before_the_start(monkeypatch):
    """gloo for ranks on the CPU, or where the host is known to hold more
    ranks than cards; NCCL where each rank can take a card of its own,
    also in a multi-host world started by hand (no ``LOCAL_WORLD_SIZE``,
    e.g. 2 hosts x 8 cards)."""
    for var in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert default_backend("cpu") == "gloo"
    if not torch.cuda.is_available():
        assert default_backend("cuda") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert default_backend("cpu") == "gloo"
    assert default_backend("cuda") == "nccl"  # 16 ranks over 2 hosts
    assert default_backend("cuda", local_world_size=8) == "nccl"
    assert default_backend("cuda", local_world_size=16) == "gloo"  # sharing cards
    monkeypatch.setenv("LOCAL_RANK", "9")
    assert default_backend("cuda") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert default_backend("cuda") == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_backend("cuda") == "gloo"  # two torchrun ranks, one card


@pytest.mark.parametrize("key", ["tensor_parallel", "pipeline_parallel",
                                 "pipeline_microbatches"])
def test_tensor_and_pipeline_parallel_name_item_10b(tmp_path_factory, key):
    """The tensor- and pipeline-parallel keys, which raised
    ``NotImplementedError`` before they were ported, are taken now, with
    the JAX trainer's checks: in one process
    ``tensor_parallel`` asks for ``torch.distributed`` (as
    ``sequence_parallel`` does), ``pipeline_parallel`` refuses the biLSTM
    with ``ValueError``, and ``pipeline_microbatches`` alone builds the
    one-process trainer (``tests/test_torch_tp_pp*.py`` run the modes)."""
    root = tmp_path_factory.mktemp("refuse")
    mp = tdemo.make_demo_experiment(str(root / "exp"), subject_ids=(1,), N_epochs=1)

    def build():
        return ttrain.MultiSubjectTrainer(mp, [1], SN_kwargs={key: 2}, VERBOSE=False,
                                          device="cpu")

    if key == "tensor_parallel":
        with pytest.raises(RuntimeError, match="make_mesh needs torch.distributed"):
            build()
    elif key == "pipeline_parallel":
        with pytest.raises(ValueError, match="requires encoder_type='conformer'"):
            build()
    else:
        trainer = build()
        assert trainer.mesh is None and trainer.pp is None
