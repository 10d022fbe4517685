"""Rank-side functions of the port's multi-rank tests.

``parallel/launch.py`` runs them on gloo ranks on the CPU (one process a
rank, one intra-op thread each); each returns JSON. They import torch
and the port only, never JAX: the test files compute JAX's side in the
test process and compare.
"""

import os

import numpy as np
import torch


def local_rows(n: int, batch: int, index: int, blocks: int) -> np.ndarray:
    """The rows of block ``index`` of every global batch (JAX's
    ``examples/multihost_launch.local_rows``)."""
    h = batch // blocks
    n_full = (n // batch) * batch
    return np.arange(n_full).reshape(-1, blocks, h)[:, index, :].ravel()


def _context():
    import tempfile
    from analytics_zoo_tpu_torch.common.context import init_orca_context
    from analytics_zoo_tpu_torch.learn import estimator
    # the fits' summaries go to a directory of the test's own
    estimator.DEFAULT_LOG_DIR = tempfile.mkdtemp(prefix="zoo_rank_logs_")
    return init_orca_context(cluster_mode="multihost", device="cpu")


def _stop():
    from analytics_zoo_tpu_torch.common.context import stop_orca_context
    stop_orca_context()


class FnMLP(torch.nn.Module):
    """JAX's ``examples/multihost_launch.build_estimator`` model: ``h =
    tanh(x @ w1 + b1); h @ w2 + b2``, its parameters under JAX's names."""

    def __init__(self, params):
        super().__init__()
        for name in ("w1", "b1", "w2", "b2"):
            setattr(self, name, torch.nn.Parameter(
                torch.tensor(np.asarray(params[name], np.float32))))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _rules(rules):
    return None if rules is None else [(p, tuple(s)) for p, s in rules]


def _feed(est, x, y, batch, data_mode):
    blocks = est._batch_shards
    index = est._mesh.data_index(est.strategy.batch_axes())
    rows = local_rows(len(x), batch, index, blocks) if blocks > 1 \
        else np.arange(len(x))
    xl, yl = x[rows], y[rows]
    if data_mode != "streaming":
        return (xl, yl)
    from analytics_zoo_tpu_torch.common.context import OrcaContext
    from analytics_zoo_tpu_torch.data import HostXShards
    from analytics_zoo_tpu_torch.data.dataset import (
        StreamingShardedDataset, to_sharded_dataset)
    OrcaContext.train_data_store = "DISK_2"
    try:
        shards = HostXShards.partition({"x": xl, "y": yl}, num_shards=4)
        data = to_sharded_dataset(shards, feature_cols=["x"],
                                  label_cols=["y"])
    finally:
        OrcaContext.train_data_store = "DRAM"
    assert isinstance(data, StreamingShardedDataset), type(data)
    return data


def mlp_fit(case):
    """JAX's multihost MLP under ``case["strategy"]`` and its rules."""
    from analytics_zoo_tpu_torch.learn import Estimator
    x, y = np.asarray(case["x"], np.float32), np.asarray(case["y"],
                                                         np.float32)
    est = Estimator.from_torch(
        model=FnMLP(case["params"]), loss="mse", optimizer="sgd",
        strategy=case["strategy"], param_rules=_rules(case.get("rules")),
        device="cpu")
    data = _feed(est, x, y, case["batch"], case.get("data", "array"))
    hist = est.fit(data, epochs=case["epochs"], batch_size=case["batch"],
                   shuffle=False)
    ev = est.evaluate(_feed(est, x, y, case["batch"], "array"),
                      batch_size=case["batch"])
    whole = est.gathered_state_dict()
    return {"loss": hist["loss"], "eval": ev["loss"],
            "params": {k: v.tolist() for k, v in whole.items()},
            "shards": {k: list(s.local_shape)
                       for k, s in est._shards.items()},
            "axes": {k: sorted(s.axes) for k, s in est._shards.items()},
            "mesh": est._mesh.shape, "rank": est._mesh.rank}


def keras_keeps_weights(case):
    """JAX ``TestStrategyPreservesWeights``: a fit under a layout that
    shards nothing, then the factory's "dp,tp2" with a rule on every
    kernel: the predictions survive the new layout."""
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.learn import Estimator
    torch.manual_seed(0)
    m = Sequential()
    m.add(Dense(8, input_shape=(4,), activation="relu"))
    m.add(Dense(2, activation="softmax"))
    # first a layout that replicates the batch and shards nothing
    m.set_strategy("tp2")
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    m.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)
    before = np.asarray(m.predict(x, batch_size=16))
    est = Estimator.from_keras(
        keras_model=m, loss="sparse_categorical_crossentropy",
        strategy="dp,tp2", param_rules=[(r"kernel", (None, "model"))])
    after = np.asarray(est.predict(x, batch_size=16))
    return {"before": before.tolist(), "after": after.tolist(),
            "covered": sorted(set(est._shards) - set(est._gathered)),
            "strategy": str(est.strategy)}


def keras_rules_kept(case):
    """JAX ``from_keras`` keeps the model's strategy and rules."""
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    from analytics_zoo_tpu_torch.learn import Estimator
    m = Sequential()
    m.add(Dense(4, input_shape=(4,), activation="relu"))
    m.add(Dense(2, activation="softmax"))
    m.set_strategy("dp2,tp4", param_rules=[(r"kernel", (None, "model"))])
    est = Estimator.from_keras(keras_model=m,
                               loss="sparse_categorical_crossentropy",
                               device="cpu")
    return {"strategy": str(est.strategy),
            "rules": [[p, list(s)] for p, s in est.strategy.param_rules],
            "shards": {k: list(s.local_shape)
                       for k, s in est._shards.items()}}


def bert_tp(case):
    """JAX ``test_tensor_parallel_bert``: BERTClassifier under "dp,tp2"
    (``bert_tp_rules``), its snapshot, and a second sharded estimator
    resuming from it."""
    from analytics_zoo_tpu_torch.text import BERTClassifier, BertConfig
    cfg = BertConfig(**case["config"])
    ids = np.asarray(case["ids"], np.int32)
    labels = np.asarray(case["labels"], np.int32)
    est = BERTClassifier(num_classes=2, config=cfg, seq_len=ids.shape[1],
                         strategy=case["strategy"], device="cpu")
    inner = est.estimator
    hist = est.fit(ids, labels, epochs=1, batch_size=case["batch"])
    pred = np.asarray(est.predict(ids, batch_size=case["batch"]))
    est.save(case["path"])
    whole = inner.gathered_state_dict()
    again = BERTClassifier(num_classes=2, config=cfg, seq_len=ids.shape[1],
                           strategy=case["strategy"], device="cpu")
    again.load(case["path"])
    resumed = again.estimator.gathered_state_dict()
    name = next(n for n in inner._shards if n.endswith(
        "block_0.attention.query.weight"))
    return {"loss": hist["loss"], "steps": inner.step_losses,
            "pred": pred.tolist(),
            "query_local": list(inner._shards[name].local_shape),
            "query_whole": list(inner._shards[name].shape),
            "resumed_bitwise": all(torch.equal(whole[k], resumed[k])
                                   for k in whole),
            "gathered": inner._gathered}


def _optimizer(spec):
    """``[name, learning rate]`` -> the port's optimizer."""
    from analytics_zoo_tpu_torch.learn.optimizers import SGD, Adam
    return {"sgd": SGD, "adam": Adam}[spec[0]](spec[1])


def bert_from_jax(case):
    """BERTClassifier under ``case["strategy"]`` (``bert_tp_rules``) from
    JAX's initial parameters (each rank loads its block,
    ``convert.flax_to_shard_state_dict``); the fit's history and the
    whole parameters after it."""
    from analytics_zoo_tpu_torch.convert import flax_to_shard_state_dict
    from analytics_zoo_tpu_torch.text import BERTClassifier, BertConfig
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    cfg = BertConfig(**case["config"])
    ids = np.asarray(case["ids"], np.int32)
    labels = np.asarray(case["labels"], np.int32)
    est = BERTClassifier(num_classes=2, config=cfg, seq_len=ids.shape[1],
                         optimizer=_optimizer(case["opt"]),
                         strategy=case["strategy"], device="cpu")
    inner = est.estimator
    inner.model.load_state_dict(flax_to_shard_state_dict(
        _arrays(case["params"]), _ClassifierModule(cfg, 2), inner.strategy,
        inner._mesh))
    hist = est.fit(ids, labels, epochs=case["epochs"],
                   batch_size=case["batch"], shuffle=False)
    return {"loss": hist["loss"],
            "params": {k: v.tolist() for k, v in
                       inner.gathered_state_dict().items()},
            "shards": {k: list(s.local_shape)
                       for k, s in inner._shards.items()},
            "gathered": inner._gathered}


def ncf_from_jax(case):
    """NeuralCF under ``case["strategy"]`` with its ``tp_param_rules``,
    from JAX's initial parameters; each rank feeds its block of every
    global batch."""
    from analytics_zoo_tpu_torch.convert import flax_to_state_dict
    from analytics_zoo_tpu_torch.models import NeuralCF
    x = np.asarray(case["x"], np.float32)
    y = np.asarray(case["y"], np.int32)
    ncf = NeuralCF(**case["args"])
    ncf.model.module.load_state_dict(flax_to_state_dict(
        _arrays(case["params"])))
    ncf.set_strategy(case["strategy"], param_rules=NeuralCF.tp_param_rules())
    ncf.compile(optimizer=_optimizer(case["opt"]),
                loss="sparse_categorical_crossentropy", device="cpu")
    est = ncf.model._ensure_estimator(for_training=True)
    xl, yl = _feed(est, x, y, case["batch"], "array")
    hist = ncf.fit(xl, yl, batch_size=case["batch"], nb_epoch=case["epochs"],
                   shuffle=False)
    return {"loss": hist["loss"],
            "params": {k: v.tolist() for k, v in
                       est.gathered_state_dict().items()},
            "shards": {k: list(s.local_shape)
                       for k, s in est._shards.items()},
            "gathered": est._gathered, "mesh": est._mesh.shape}


def fit_group(cases):
    """Every case of one rank group, in order; the results by case
    name."""
    _context()
    try:
        return {c["name"]: globals()[c["fn"]](c) for c in cases}
    finally:
        _stop()


# ------------------------------------------------------------ collectives

def collectives(world):
    """Each collective over the ranks against the same data movement on
    one rank (every rank builds every rank's input from its seed)."""
    from analytics_zoo_tpu_torch.parallel import collectives as C
    from analytics_zoo_tpu_torch.parallel import mesh as M
    _context()
    try:
        mesh = M.build_mesh((M.DATA_AXIS,), (world,))
        r = mesh.rank

        def inp(rank, shape, salt):
            g = np.random.default_rng(1000 * salt + rank)
            return torch.from_numpy(g.standard_normal(shape).astype(
                np.float32))
        out = {}
        xs = [inp(i, (3, 4 * world), 0) for i in range(world)]
        got = C.all_gather(xs[r], mesh, "data", 1)
        out["all_gather"] = torch.equal(got, torch.cat(xs, 1))
        got = C.all_to_all(xs[r], mesh, "data", 1, 0)
        out["all_to_all"] = torch.equal(got, torch.cat(
            [x[:, r * 4:(r + 1) * 4] for x in xs], 0))
        got = C.ring_shift(xs[r], mesh, "data")
        out["ring_shift"] = torch.equal(got, xs[(r - 1) % world])
        got = C.all_reduce(xs[r], mesh, "data")
        total = sum(x.double() for x in xs)
        # 1 ulp a summand
        ulp = world * torch.finfo(torch.float32).eps * sum(
            x.abs().double() for x in xs)
        out["all_reduce"] = bool(((got.double() - total).abs()
                                  <= ulp).all())
        ys = [inp(i, (2 * world, 5), 1) for i in range(world)]
        got = C.reduce_scatter(ys[r], mesh, "data", 0)
        total = sum(y.double() for y in ys)[2 * r:2 * (r + 1)]
        ulp = world * torch.finfo(torch.float32).eps * sum(
            y.abs().double() for y in ys)[2 * r:2 * (r + 1)]
        out["reduce_scatter"] = bool(((got.double() - total).abs()
                                      <= ulp).all())
        # the backwards are the adjoints: <A x, g> == <x, A* g>
        x = xs[r].clone().requires_grad_()
        gs = [inp(i, (3, 4 * world * world), 2) for i in range(world)]
        (C.all_gather(x, mesh, "data", 1) * gs[r]).sum().backward()
        want = sum(g for g in gs)[:, r * 4 * world:(r + 1) * 4 * world]
        out["all_gather_grad"] = bool(torch.allclose(x.grad, want,
                                                     atol=1e-5))
        x = xs[r].clone().requires_grad_()
        ga = [inp(i, (3 * world, 4), 3) for i in range(world)]
        (C.all_to_all(x, mesh, "data", 1, 0) * ga[r]).sum().backward()
        want = torch.cat([g[3 * r:3 * (r + 1)] for g in ga], 1)
        out["all_to_all_grad"] = torch.equal(x.grad, want)
        x = xs[r].clone().requires_grad_()
        (C.ring_shift(x, mesh, "data") * xs[(r + 1) % world]).sum() \
            .backward()
        out["ring_shift_grad"] = torch.equal(x.grad, xs[(r + 2) % world])
        out["table"] = C.staging_table()
        return out
    finally:
        _stop()


# ------------------------------------------------------ ring and Ulysses

def attention(cases):
    """Ring and Ulysses attention over the ``seq`` axis: the output and
    the gradients of q, k and v of the global loss (each rank holds the
    whole output, so each rank's loss is divided by the axis size)."""
    from analytics_zoo_tpu_torch.ops.ring_attention import ring_attention
    from analytics_zoo_tpu_torch.ops.ulysses import ulysses_attention
    from analytics_zoo_tpu_torch.parallel import collectives as C
    from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy
    _context()
    try:
        out = {}
        meshes = {}
        for case in cases:
            strat = case["strategy"]
            if strat not in meshes:
                meshes[strat] = ShardingStrategy.parse(strat).build_mesh()
            mesh = meshes[strat]
            q, k, v = (torch.tensor(np.asarray(a, np.float32))
                       .requires_grad_() for a in case["qkv"])
            g = torch.tensor(np.asarray(case["g"], np.float32))
            blocks = mesh.shape.get("data", 1)
            if blocks > 1:
                # a data axis: each rank its rows
                b = q.shape[0] // blocks
                i = mesh.coord("data")
                q, k, v = (t.detach()[i * b:(i + 1) * b].requires_grad_()
                           for t in (q, k, v))
                g = g[i * b:(i + 1) * b]
            fn = ring_attention if case["kind"] == "ring" \
                else ulysses_attention
            kw = dict(mesh=mesh, causal=case["causal"],
                      use_flash=case["use_flash"])
            if case["kind"] == "ring":
                kw["flash_block"] = case.get("flash_block", 128)
                kw["batch_axis"] = "data" if blocks > 1 else None
            res = fn(q, k, v, **kw)
            p = mesh.shape["seq"]
            ((res * g).sum() / p).backward()
            grads = [C.all_reduce_(t.grad.clone(), mesh, ["seq"])
                     for t in (q, k, v)]
            if blocks > 1:
                res = C.gather_axes(res.detach(), mesh, ["data"], 0)
                grads = [C.gather_axes(t, mesh, ["data"], 0) for t in grads]
            out[case["name"]] = {"out": res.detach().tolist(),
                                 "grads": [t.tolist() for t in grads]}
        return out
    finally:
        _stop()


# ------------------------------------------------------------------ MoE

class MoENet(torch.nn.Module):
    """JAX ``test_moe``'s ``Net``: a MoE block named ``moe`` and a Dense
    head (flax's auto-name ``Dense_0``)."""

    def __init__(self, n_experts, d_model, d_hidden, k=2):
        super().__init__()
        from analytics_zoo_tpu_torch.common.flax_compat import Dense
        from analytics_zoo_tpu_torch.ops.moe import MoEModule
        self.moe = MoEModule(n_experts, d_model, d_hidden, k=k)
        self.Dense_0 = Dense(d_model, 2)

    def forward(self, x, train: bool = False):
        return self.Dense_0(self.moe(x, train=train))


def moe_fit(cases):
    """The MoE net's fit under each case's strategy with
    ``ep_param_rules``, and one forward's aux loss and gradients."""
    from analytics_zoo_tpu_torch.convert import flax_to_state_dict
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.ops import moe
    _context()
    try:
        out = {}
        for case in cases:
            net = MoENet(*case["dims"], k=case["k"])
            net.load_state_dict(flax_to_state_dict(_arrays(case["params"])))
            x = np.asarray(case["x"], np.float32)
            y = np.asarray(case["y"], np.int32)
            est = Estimator.from_torch(
                model=net, loss="sparse_categorical_crossentropy_logits",
                optimizer=case["opt"], strategy=case["strategy"],
                param_rules=moe.ep_param_rules(), device="cpu",
                seed=0)
            est.aux_loss_weight = case["aux_weight"]
            blocks = est._batch_shards
            index = est._mesh.data_index(est.strategy.batch_axes())
            rows = local_rows(len(x), case["batch"], index, blocks) \
                if blocks > 1 else np.arange(len(x))
            # one step's objective pieces on the first global batch
            xb = torch.from_numpy(x[rows[:case["batch"] // blocks]])
            with moe.collect_aux_losses() as aux:
                est._forward(xb, train=True)
            hist = est.fit((x[rows], y[rows]), epochs=case["epochs"],
                           batch_size=case["batch"], shuffle=False)
            out[case["name"]] = {
                "loss": hist["loss"], "steps": est.step_losses,
                "aux": float(aux[0]),
                "params": {k: v.tolist() for k, v in
                           est.gathered_state_dict().items()},
                "covered": sorted(set(est._shards) - set(est._gathered)),
                "dispatched": est.model.moe.last_dispatch}
        return out
    finally:
        _stop()


def _arrays(tree):
    return {k: _arrays(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def environment():
    """What a launched rank sees (the launcher's torchrun names)."""
    import torch.distributed as dist
    return {k: os.environ[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                       "MASTER_ADDR")} | {
        "backend": str(dist.get_backend()),
        "threads": torch.get_num_threads()}


def tcmf_group(cases):
    """TCMF's ``distributed=True`` fits of ``tests/test_torch_tcmf_ranks.
    py``: the series blocked over the ranks, from the given start."""
    _context()
    try:
        return {c["name"]: tcmf_fit(c) for c in cases}
    finally:
        _stop()


def tcmf_fit(case):
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster
    y = np.asarray(case["y"], np.float32)
    f0 = np.asarray(case["f0"], np.float32)
    x0 = np.asarray(case["x0"], np.float32)
    m = TCMFForecaster(k=f0.shape[1], ar_order=24, lr=0.05, device="cpu")
    m._init_factors = lambda _y: (f0.copy(), x0.copy())
    mse = m.fit(y, num_steps=case["steps"], distributed=True)
    return {"mse": mse, "report": m.fit_report,
            "pred": m.predict(8).tolist(), "F": m.F.tolist(),
            "X": m.X.tolist()}
