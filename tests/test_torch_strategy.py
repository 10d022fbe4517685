"""The port's strategies, mesh, context across ranks, collectives and the
weights' shards against the JAX package, on the CPU (mirrors JAX
``tests/test_context.py:35-55``, ``test_keras2_multihost.py``'s
bootstrap tests and ``test_estimator_factories.py``'s rule keeping).

- ``ShardingStrategy``: JAX's grammar (``parse``, ``axis_names``,
  ``uses``, ``batch_axes``, ``batch_spec``, ``str``) over a list of
  layouts; ``param_spec`` equal to JAX's for every leaf of BERT (with
  ``bert_tp_rules``), NeuralCF and Wide&Deep (their ``tp_param_rules``)
  and an MLP (rules on flax's names), under tp, fsdp and mixed layouts
  on a mesh of 8, JAX's over its 8 virtual devices: the rules read
  flax's paths and shapes (``convert.flax_paths``), a rule that does
  not divide is dropped (the 5-class head), one naming an axis the mesh
  lacks is skipped, and fsdp takes JAX's dim.
- ``TorchShard``: every rank's block of every sharded BERT leaf under
  "dp2,tp4" puts back the whole bitwise; the Megatron leaves are
  contiguous blocks of torch's dims; ``flax_to_shard_state_dict`` is
  the blocks of ``flax_to_state_dict``.
- ``init_orca_context(cluster_mode="multihost")``: the process group's
  arguments from the call (``init_process_group`` monkeypatched), from
  torchrun's environment, ``ValueError`` without either, more ranks on a
  host than cards refused naming both counts; the C20 flags.
- The collectives over 2 and 4 gloo ranks (``parallel/launch.py``):
  data movement bitwise, sums within 1 ulp a summand, each backward the
  adjoint of its forward; the staging table of a gloo group.
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as ctx_mod
from analytics_zoo_tpu_torch.convert import (flax_paths,
                                             flax_to_shard_state_dict,
                                             flax_to_state_dict, shard_plan)
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
from analytics_zoo_tpu_torch.parallel.launch import launch
from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_multirank_workers.py")
LAYOUTS = ["dp", "fsdp", "dp2,tp4", "tp2", "dp2,sp2,tp2", "ep4", "fsdp-1",
           "sp8", "dp4,fsdp2", "tp4,dp2", "dp2,ep4", "pp", "dp,tp2"]
BERT = dict(vocab=64, hidden_size=32, n_block=2, n_head=4,
            intermediate_size=64, max_position_len=16)
NCF = dict(user_count=30, item_count=20, class_num=5, user_embed=8,
           item_embed=8, hidden_layers=[16, 8, 4], mf_embed=8)
WND = dict(wide_base_cols=["a", "b"], wide_base_dims=[10, 10],
           wide_cross_cols=["ab"], wide_cross_dims=[20],
           indicator_cols=["c"], indicator_dims=[4],
           embed_cols=["u", "i"], embed_in_dims=[30, 40],
           embed_out_dims=[8, 16], continuous_cols=["age"])


@pytest.fixture(autouse=True)
def _clean():
    yield
    ctx_mod.stop_orca_context()
    mesh_lib.set_default_mesh(None)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.parallel import strategy as jstrategy
    return jax, jstrategy


def _local_mesh(strategy: ShardingStrategy, n: int = 8, rank: int = 0):
    """The port's mesh of ``n`` ranks as rank ``rank`` sees it (no
    process group: the layout only)."""
    shape = mesh_lib._resolve_shape(strategy.axis_names(),
                                    [s for _, s in strategy.sizes], n)
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device("cpu")] * n
    return mesh_lib.DeviceMesh(grid.reshape(shape), strategy.axis_names(),
                               rank=rank)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_parse_matches_jax(jx, layout):
    _, js = jx
    want = js.ShardingStrategy.parse(layout)
    got = ShardingStrategy.parse(layout)
    assert got.sizes == want.sizes and str(got) == str(want)
    assert got.axis_names() == want.axis_names()
    assert got.uses == want.uses and got.batch_axes() == want.batch_axes()
    for ndim in (1, 3):
        assert got.batch_spec(ndim) == tuple(want.batch_spec(ndim))


@pytest.mark.parametrize("bad", ["dp2,xp", "tp2x", "dp2,,tp-"])
def test_bad_tokens_raise_as_jax(jx, bad):
    _, js = jx
    for cls in (js.ShardingStrategy, ShardingStrategy):
        try:
            cls.parse(bad)
        except ValueError:
            continue
        # a spelling JAX takes is taken alike
        assert ShardingStrategy.parse(bad).sizes == \
            js.ShardingStrategy.parse(bad).sizes


def _jax_tree(kind):
    import jax
    import jax.numpy as jnp
    if kind == "bert":
        from analytics_zoo_tpu.text.bert import BertConfig, BertModule
        ids = jnp.zeros((2, 8), jnp.int32)
        return jax.device_get(BertModule(BertConfig(**BERT)).init(
            jax.random.PRNGKey(0), ids)["params"])
    if kind == "ncf":
        from analytics_zoo_tpu.models import NeuralCF
        return jax.device_get(NeuralCF(**NCF).model.get_weights())
    if kind == "wnd":
        from analytics_zoo_tpu.models.recommendation import (
            ColumnFeatureInfo, WideAndDeep)
        return jax.device_get(WideAndDeep(
            2, ColumnFeatureInfo(**WND)).model.get_weights())
    import flax.linen as nn

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = nn.relu(nn.Dense(16)(x))
            return nn.Dense(5)(h)
    return jax.device_get(MLP().init(jax.random.PRNGKey(0),
                                     jnp.zeros((2, 8)))["params"])


def _port_module(kind):
    if kind == "bert":
        from analytics_zoo_tpu_torch.text.bert import BertConfig, BertModule
        return BertModule(BertConfig(**BERT))
    if kind == "ncf":
        from analytics_zoo_tpu_torch.models import NeuralCF
        return NeuralCF(**NCF).model.module
    if kind == "wnd":
        from analytics_zoo_tpu_torch.models.recommendation import (
            ColumnFeatureInfo, WideAndDeep)
        return WideAndDeep(2, ColumnFeatureInfo(**WND)).model.module

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = torch.nn.Linear(8, 16)
            self.Dense_1 = torch.nn.Linear(16, 5)
    return MLP()


def _rules(kind):
    if kind == "bert":
        from analytics_zoo_tpu_torch.text.bert import bert_tp_rules
        return bert_tp_rules()
    if kind == "ncf":
        from analytics_zoo_tpu_torch.models import NeuralCF
        return NeuralCF.tp_param_rules()
    if kind == "wnd":
        from analytics_zoo_tpu_torch.models.recommendation import WideAndDeep
        return WideAndDeep.tp_param_rules()
    # a stale expert rule is skipped where the mesh has no expert axis
    return [(r"Dense_\d+/kernel$", (None, "model")),
            (r"Dense_0/bias$", ("expert",))]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("layout", ["dp2,tp4", "tp2", "fsdp", "dp2,fsdp4",
                                    "dp4,tp2", "tp8"])
@pytest.mark.parametrize("kind", ["bert", "ncf", "wnd", "mlp"])
def test_param_specs_match_jax(jx, kind, layout):
    _, js = jx
    want = js.ShardingStrategy.parse(layout, param_rules=_rules(kind))
    jm = want.build_mesh(set_default=False)
    got = ShardingStrategy.parse(layout, param_rules=_rules(kind))
    pm = _local_mesh(got)
    assert pm.shape == dict(zip(jm.axis_names, jm.devices.shape))
    tree = _flat(_jax_tree(kind))
    paths = {path: shape for path, shape, _ in
             flax_paths(_port_module(kind)).values()}
    assert set(paths) == set(tree)
    for path, leaf in tree.items():
        assert paths[path] == tuple(leaf.shape), path
        spec = tuple(want.param_spec(path, leaf.shape, jm))
        assert got.param_spec(path, paths[path], pm) == spec, path
    # the whole tree at once, keyed like it
    got_tree = _flat(got.param_shardings(_jax_tree(kind), pm))
    assert got_tree == {p: tuple(want.param_spec(p, leaf.shape, jm))
                        for p, leaf in tree.items()}


def test_rules_dropped_and_skipped():
    s = ShardingStrategy.parse("dp2,tp2", param_rules=[
        (r"head/kernel", (None, "model")), (r"x/kernel", ("expert", None)),
        (r"x/kernel", (None, "model"))])
    mesh = _local_mesh(s, 4)
    # 5 classes do not divide over tp2: dropped, replicated
    assert s.param_spec("head/kernel", (8, 5), mesh) == ()
    # the expert rule is skipped, the next one matches
    assert s.param_spec("x/kernel", (8, 6), mesh) == (None, "model")
    f = ShardingStrategy.parse("dp2,fsdp2", param_rules=[
        (r"head/kernel", (None, "model"))])
    # the fallback on a dropped rule is fsdp's largest divisible dim
    assert f.param_spec("head/kernel", (8, 5),
                        _local_mesh(f, 4)) == ("fsdp", None)


def _whole_from_blocks(shard_of_rank, full, n):
    """The whole tensor put back from every rank's block, in its view."""
    first = shard_of_rank(0)
    out = torch.full(first.view, float("nan"))
    for r in range(n):
        shard = shard_of_rank(r)
        block = shard.block(full).reshape(shard.local_view)
        idx = []
        for d, size in enumerate(shard.view):
            if d in shard.dims:
                step = size // shard.ways(d)
                i = shard.mesh.data_index(shard.dims[d])
                idx.append(slice(i * step, (i + 1) * step))
            else:
                idx.append(slice(None))
        out[tuple(idx)] = block
    return out.reshape(first.shape)


@pytest.mark.parametrize("layout", ["dp2,tp4", "fsdp", "dp2,fsdp2,tp2"])
def test_blocks_put_back_the_whole(layout):
    from analytics_zoo_tpu_torch.text.bert import (BertConfig, BertModule,
                                                   bert_tp_rules)
    m = BertModule(BertConfig(**BERT))
    s = ShardingStrategy.parse(layout, param_rules=bert_tp_rules())
    plans = [shard_plan(m, s, _local_mesh(s, 8, r)) for r in range(8)]
    assert plans[0], layout
    whole = dict(m.named_parameters())
    for name in plans[0]:
        got = _whole_from_blocks(lambda r: plans[r][name],
                                 whole[name].detach(), 8)
        assert torch.equal(got, whole[name].detach()), name
        assert np.prod(plans[0][name].local_shape) < whole[name].numel()


def test_megatron_blocks_are_contiguous():
    from analytics_zoo_tpu_torch.text.bert import (BertConfig, BertModule,
                                                   bert_tp_rules)
    m = BertModule(BertConfig(**BERT))
    s = ShardingStrategy.parse("tp4", param_rules=bert_tp_rules())
    for r in range(4):
        plan = shard_plan(m, s, _local_mesh(s, 4, r))
        dims = {n.split("block_0.")[-1]: p.torch_dim for n, p in plan.items()
                if "block_0" in n}
        assert dims == {"attention.query.weight": 0,
                        "attention.key.weight": 0,
                        "attention.value.weight": 0,
                        "attention.out.weight": 1,
                        "intermediate.weight": 0, "output.weight": 1}
        q = plan["block_0.attention.query.weight"]
        w = m.block_0.attention.query.weight.detach()
        assert torch.equal(q.block(w), w[r * 8:(r + 1) * 8])
        assert plan["word_embeddings.embedding"].local_shape == (64, 8)


def test_shard_state_dict_is_the_blocks(jx):
    from analytics_zoo_tpu_torch.text.bert import BertConfig, BertModule
    params = _jax_tree("bert")
    m = BertModule(BertConfig(**BERT))
    s = ShardingStrategy.parse("dp2,tp4", param_rules=_rules("bert"))
    whole = flax_to_state_dict(params)
    for r in (0, 5):
        mesh = _local_mesh(s, 8, r)
        got = flax_to_shard_state_dict(params, m, s, mesh)
        plan = shard_plan(m, s, mesh)
        assert set(got) == set(whole)
        for k, v in got.items():
            want = plan[k].block(whole[k]) if k in plan else whole[k]
            assert torch.equal(v, want), k


def test_mesh_build_and_global_batch():
    """JAX ``test_mesh_build_and_global_batch`` over 8 devices of this
    process; ``place_on_mesh`` gives a rank's block."""
    mesh = mesh_lib.build_mesh(axes=("data", "model"), shape=(4, -1),
                               devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    gx = mesh_lib.local_batch_to_global({"x": x}, mesh)["x"]
    assert gx.shape == (8, 4) and np.array_equal(gx.numpy(), x)
    s = ShardingStrategy.parse("dp2,tp4")
    for r in range(8):
        m = _local_mesh(s, 8, r)
        got = mesh_lib.place_on_mesh(x.astype(np.float64), m,
                                     lambda a: ("data", "model"))
        i, j = m.coord("data"), m.coord("model")
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), x[4 * i:4 * (i + 1),
                                            j:j + 1])
    assert mesh_lib.mesh_axis_size(mesh, "seq") == 1


def test_strategy_parse_and_mesh():
    """JAX ``test_strategy_parse_and_specs`` on this process's 8 CPU
    devices; a strategy needing ranks this process has not refuses."""
    s = ShardingStrategy.parse("dp2,tp4")
    mesh = s.build_mesh(devices=[torch.device("cpu")] * 8,
                        set_default=False)
    assert mesh.shape == {"data": 2, "model": 4}
    assert s.batch_spec(2) == ("data", None)
    assert ShardingStrategy.parse("dp").build_mesh(
        devices=[torch.device("cpu")] * 8).shape == {"data": 8}
    with pytest.raises(ValueError, match="cover"):
        ShardingStrategy.parse("dp2,tp4").build_mesh(
            devices=[torch.device("cpu")] * 4)


def test_set_strategy_keeps_rules():
    """JAX ``test_strategy_only_keeps_rules``."""
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    m = Sequential()
    m.add(Dense(2, input_shape=(4,), activation="softmax"))
    m.set_strategy("dp", param_rules=[(r"kernel", (None, "model"))])
    m.set_strategy("dp2,tp2")
    assert m._param_rules == [(r"kernel", (None, "model"))]
    assert m._strategy == "dp2,tp2"


def test_feed_fraction_and_blocks():
    """Each rank feeds ``batch * fraction`` rows of its own data; the
    blocks of the ranks in data-index order are the global batches."""
    from analytics_zoo_tpu_torch.data.dataset import ShardedDataset
    import sys
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_multirank_workers import local_rows
    x = np.arange(96, dtype=np.float32)[:, None]
    for layout, want in (("dp2,tp2", 0.5), ("tp4", 1.0), ("dp2,fsdp2", .25)):
        s = ShardingStrategy.parse(layout)
        assert s.batch_feed_fraction(_local_mesh(s, 4)) == want
    s = ShardingStrategy.parse("dp4")
    got = []
    for r in range(4):
        m = _local_mesh(s, 4, r)
        ds = ShardedDataset(x[local_rows(96, 32, m.data_index(("data",)), 4)])
        got.append([b for b, _, _ in ds.iter_batches(
            32, process_fraction=s.batch_feed_fraction(m))])
    for k in range(3):
        glob = np.concatenate([got[r][k] for r in range(4)])
        assert np.array_equal(glob[:, 0], np.arange(32 * k, 32 * (k + 1)))
    with pytest.raises(ValueError, match="divide"):
        next(ShardedDataset(x).iter_batches(30, process_fraction=0.25))


def test_device_iterators_on_one_rank():
    from analytics_zoo_tpu_torch.data.dataset import ShardedDataset
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.int32)
    ds = ShardedDataset(x, y)
    s = ShardingStrategy.parse("dp")
    mesh = s.build_mesh(devices=[torch.device("cpu")], set_default=False)
    got = list(ds.device_iterator(mesh, s, 8, drop_remainder=False))
    want = list(ds.iter_batches(8, drop_remainder=False))
    assert len(got) == len(want) == 3
    for (gx, gy, gm), (wx, wy, wm) in zip(got, want):
        assert np.array_equal(gx.numpy(), wx) and np.array_equal(gy.numpy(),
                                                                 wy)
        assert (gm is None) == (wm is None)
    scan = list(ds.device_scan_iterator(mesh, s, 8, 2))
    assert [k for _, _, k in scan] == [2]
    with pytest.raises(ValueError, match="divisible"):
        list(ds.device_iterator(_local_mesh(ShardingStrategy.parse("dp4"), 4),
                                ShardingStrategy.parse("dp4"), 6))


# ---------------------------------------------------- the context


def test_multihost_calls_init_process_group(monkeypatch):
    """JAX ``test_multihost_calls_distributed_initialize``: the group's
    address, size and rank from the call."""
    import torch.distributed as dist
    calls = {}

    def fake_init(backend=None, init_method=None, world_size=None,
                  rank=None, **kw):
        calls.update(backend=backend, init_method=init_method,
                     world=world_size, rank=rank)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    ctx = ctx_mod.init_orca_context(cluster_mode="multihost", device="cpu",
                                    coordinator_address="10.0.0.1:1234",
                                    num_processes=4, process_id=2)
    assert calls == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                     "world": 4, "rank": 2}
    assert (ctx.num_processes, ctx.process_index) == (4, 2)
    assert ctx.owns_group


def test_multihost_reads_torchrun_env(monkeypatch):
    import torch.distributed as dist
    calls = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.update(kw))
    for k, v in dict(MASTER_ADDR="127.0.0.9", MASTER_PORT="2222",
                     RANK="1", WORLD_SIZE="3", LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    ctx_mod.init_orca_context(cluster_mode="tpu_pod", device="cpu")
    assert calls == {"init_method": "tcp://127.0.0.9:2222", "world_size": 3,
                     "rank": 1}


def test_multihost_requires_coordinator(monkeypatch):
    """JAX ``test_multihost_requires_coordinator``."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        ctx_mod.init_orca_context(cluster_mode="multihost", device="cpu")
    assert ctx_mod.active_context() is None


def test_more_ranks_than_cards_refused(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: None)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match=r"local rank 1 on a host with 1 "):
        ctx_mod.init_orca_context(cluster_mode="multihost",
                                  coordinator_address="127.0.0.1:1",
                                  num_processes=2, process_id=1)


def test_adopted_group_takes_the_card_unless_told(monkeypatch):
    """A group the caller made is adopted on the device asked for; with
    none asked for it needs CUDA, as the other paths do."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctx_mod.init_orca_context(cluster_mode="multihost")
    assert ctx_mod.active_context() is None
    got = ctx_mod._join_ranks(None, None, None, "cpu")
    assert got == (torch.device("cpu"), False, 2, 1)


def test_cudnn_is_deterministic_under_the_context():
    """C20: a fit repeats bit for bit by default; the flags go back."""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    ctx_mod.init_orca_context(device="cpu")
    assert cudnn.deterministic and not cudnn.benchmark
    ctx_mod.stop_orca_context()
    assert (cudnn.deterministic, cudnn.benchmark) == before


# ------------------------------------------------------ collectives

@pytest.fixture(scope="module")
def collective_runs():
    return {n: launch(f"{WORKERS}:collectives", n, args=(n,))
            for n in (2, 4)}


@pytest.mark.parametrize("op", ["all_gather", "all_to_all", "ring_shift",
                                "all_reduce", "reduce_scatter",
                                "all_gather_grad", "all_to_all_grad",
                                "ring_shift_grad"])
@pytest.mark.parametrize("world", [2, 4])
def test_collectives(collective_runs, world, op):
    assert all(r[op] for r in collective_runs[world]), op


def test_gloo_staging_table(collective_runs):
    table = collective_runs[2][0]["table"]
    assert table == {"all_reduce": "direct", "broadcast": "direct",
                     "all_gather": "direct", "reduce_scatter": "direct",
                     "all_to_all": "direct", "ring_shift": "staged"}
