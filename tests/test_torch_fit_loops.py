"""``TorchEstimator.fit``'s loop modes and profile window, on the CPU,
against the per-step fit and the JAX package's estimator.

- ``steps_per_loop=k`` (JAX ``tests/test_estimator_edge.py``'s
  ``TestStepsPerLoop``): 96 rows, batch 16, 2 epochs of 6 steps, loops of
  4 and a tail of 2: bitwise the per-step fit (parameters, step losses,
  history; with dropout, whose seed follows the step), 12 steps; the
  loss read back once per summary window, and the ``step`` fault seam
  one arrival a loop.
- ``cache="device"`` (JAX ``tests/test_estimator.py``'s cached-epoch
  tests): with ``shuffle=False`` bitwise the per-step fit; shuffled, every
  row once an epoch, the same order for the same seed and epoch, and the
  loss falling over 8 epochs; one read-back an epoch; an unknown mode, a
  streaming set and an unlabelled set raise JAX's errors.
- NCF (users 50, items 40, Adam, batch 64, 4 steps an epoch, 3 epochs)
  through keras ``fit``: ``steps_per_loop=3`` and ``cache="device"`` with
  ``shuffle=False`` against JAX's fits in the same modes, within the NCF
  fit limits of ``tests/test_torch_keras_train.py`` (losses rtol 1e-5;
  parameters within 1e-5 in all but 1% of each leaf and within 2 lr a
  step everywhere).
- ``steps_per_loop`` over the streaming feed (JAX
  ``tests/test_data.py``'s ``test_streaming_dataset_scan_iterator``): 24
  steps over 3 epochs, the window bound held, bitwise the per-step
  streaming fit.
- ``SeveralIteration(3)`` with ``steps_per_loop=4`` snapshots at JAX's
  steps (4, 6, 10, 12); a faulted, auto-resumed loop fit ends bitwise
  where an unfaulted one ends.
- ``profile_steps=(2, 5)`` writes a trace under
  ``<tensorboard dir>/plugins/profile`` holding steps 2, 3 and 4 and no
  other; an empty window raises.

JAX is imported by fixtures only.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common import resilience
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.common.flax_compat import Dense
from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.data import (HostXShards, ShardedDataset,
                                          StreamingShardedDataset,
                                          to_sharded_dataset)
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
from analytics_zoo_tpu_torch.learn import estimator as est_lib
from analytics_zoo_tpu_torch.learn.optimizers import Adam
from analytics_zoo_tpu_torch.learn.trigger import SeveralIteration
from analytics_zoo_tpu_torch.models import NeuralCF

USERS, ITEMS, WIDTH = 50, 40, 8
NCF_ARGS = dict(user_count=USERS, item_count=ITEMS, class_num=5,
                user_embed=WIDTH, item_embed=WIDTH, hidden_layers=(16, 8),
                include_mf=True, mf_embed=WIDTH)
NCF_LR, NCF_BATCH, NCF_ROWS, NCF_EPOCHS = 1e-2, 64, 256, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch, tmp_path):
    monkeypatch.setattr(est_lib, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("ZOO_FAULT_PLAN", raising=False)
    resilience.reset_for_tests()
    yield
    resilience.install_plan(None)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import flax.linen as fnn
    from jax.sharding import Mesh
    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.learn.trigger import \
        SeveralIteration as JSeveralIteration
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF
    return dict(jax=jax, fnn=fnn, Mesh=Mesh, Estimator=JEstimator,
                Adam=JAdam, SeveralIteration=JSeveralIteration, NCF=JNCF)


class Net(nn.Module):
    def __init__(self, n_out=2, drop=0.0):
        super().__init__()
        self.hidden = Dense(4, 8)
        self.out = Dense(8, n_out)
        self.drop = drop

    def forward(self, x, train: bool = False):
        h = torch.tanh(self.hidden(x))
        if self.drop:
            h = F.dropout(h, self.drop, training=train)
        return self.out(h)


def _cls_data(n=96, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int32)


def _reg_data(n=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    return x, (x @ np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
               + 0.1).astype(np.float32)


def _est(model_dir=None, drop=0.0, loss="sparse_categorical_crossentropy_"
         "logits", optimizer="sgd", n_out=2):
    torch.manual_seed(0)
    return Estimator.from_torch(model=Net(n_out, drop), loss=loss,
                                optimizer=optimizer, model_dir=model_dir,
                                device="cpu")


def _same(a, b):
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert a.step_losses == b.step_losses


# ------------------------------------------------------------ the loop

@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_fused_loop_matches_per_step(drop):
    x, y = _cls_data()
    a, b = _est(drop=drop), _est(drop=drop)
    ha = a.fit((x, y), epochs=2, batch_size=16, shuffle=False)
    hb = b.fit((x, y), epochs=2, batch_size=16, shuffle=False,
               steps_per_loop=4)
    assert ha == hb
    _same(a, b)
    assert a._py_step == b._py_step == 12


def test_tail_group_and_read_backs():
    x, y = _cls_data()
    ds = ShardedDataset(x, y)
    groups = [k for _, _, k in ds.device_scan_iterator(
        torch.device("cpu"), 16, 4)]
    assert groups == [4, 2]
    xs, ys, _ = next(ds.device_scan_iterator(torch.device("cpu"), 16, 4,
                                             shuffle=True, seed=3, epoch=1))
    want = list(ds.iter_batches(16, True, seed=3, epoch=1))[:4]
    for i, (wx, wy, _) in enumerate(want):
        np.testing.assert_array_equal(xs[i].numpy(), wx)
        np.testing.assert_array_equal(ys[i].numpy(), wy)
    # one read-back per summary window (loops of 4 + 2 reach 5 at 6), one
    # fault arrival per loop
    inj = resilience.install_plan("wedge@step:99")
    est = _est()
    h = est.fit((x, y), epochs=2, batch_size=16, steps_per_loop=4,
                summary_interval=5)
    assert np.isfinite(h["loss"]).all()
    assert [s for s, _ in est.get_train_summary("Loss")] == [6, 12]
    assert inj.counts() == {"step": 4}


# ------------------------------------------------------------ the cache

def test_cached_epoch_matches_per_step():
    x, y = _reg_data()
    a = _est(loss="mse", optimizer="adam", n_out=1)
    b = _est(loss="mse", optimizer="adam", n_out=1)
    ha = a.fit((x, y), epochs=3, batch_size=32, shuffle=False)
    hb = b.fit((x, y), epochs=3, batch_size=32, shuffle=False,
               cache="device")
    assert ha == hb
    _same(a, b)
    assert a._py_step == b._py_step == 12
    # summaries come once an epoch
    assert [s for s, _ in b.get_train_summary("Loss")] == [4, 8, 12]


def test_cached_epoch_visits_every_row_once():
    x, _ = _reg_data(100)
    y = np.arange(100, dtype=np.float32)[:, None]     # a row's own index
    seen = []

    def run(epochs):
        est = _est(loss="mse", optimizer="adam", n_out=1)
        real = est._step
        est._step = lambda bx, by, w: (seen.append(by.numpy().ravel()),
                                       real(bx, by, w))[1]
        est.fit((x, y), epochs=epochs, batch_size=32, cache="device")
        return [np.concatenate(seen[i:i + 3]) for i in range(0, len(seen),
                                                            3)]
    first = run(2)
    seen.clear()
    again = run(1)
    for rows in first:
        assert len(rows) == 96 and len(set(rows.tolist())) == 96
    assert not np.array_equal(first[0], first[1])
    np.testing.assert_array_equal(again[0], first[0])
    x, y = _reg_data()
    h = _est(loss="mse", optimizer="adam", n_out=1).fit(
        (x, y), epochs=8, batch_size=32, cache="device")
    assert h["loss"][-1] < h["loss"][0]


def test_cache_errors(tmp_path):
    x, y = _reg_data(64)
    est = _est(loss="mse", n_out=1)
    with pytest.raises(ValueError, match="unknown cache mode"):
        est.fit((x, y), batch_size=32, cache="hbm")
    with pytest.raises(ValueError, match="materialized labelled"):
        est.fit(x, batch_size=32, cache="device")
    prev = OrcaContext.train_data_store
    OrcaContext.train_data_store = "DISK_2"
    try:
        shards = HostXShards([{"x": x[i::2], "y": y[i::2]}
                              for i in range(2)])
        ds = to_sharded_dataset(shards)
        assert isinstance(ds, StreamingShardedDataset)
        with pytest.raises(ValueError, match="materialized labelled"):
            est.fit(ds, batch_size=16, cache="device")
    finally:
        OrcaContext.train_data_store = prev
    with pytest.raises(ValueError, match="batch_size"):
        est.fit((x, y), batch_size=100, cache="device")
    # the device copy is made once per dataset object
    ds = ShardedDataset(x, y)
    est.fit(ds, batch_size=32, cache="device")
    held = est._cached
    est.fit(ds, batch_size=32, cache="device")
    assert est._cached is held
    est.fit(ShardedDataset(x, y), batch_size=32, cache="device")
    assert est._cached is not held


# ---------------------------------------------------- NCF against JAX's

def _ncf_pairs(n, seed):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.randint(1, USERS + 1, n),
                  rng.randint(1, ITEMS + 1, n)], 1).astype(np.float32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


@pytest.fixture(scope="module")
def jax_ncf_fits(jx):
    """JAX's NCF fits with ``steps_per_loop=3`` and ``cache="device"`` (on
    one device: JAX's cache needs an unsharded batch), and the initial
    parameters."""
    jax = jx["jax"]
    x, y = _ncf_pairs(NCF_ROWS, 0)
    out = {}
    for mode, kw in (("loop", {"steps_per_loop": 3}),
                     ("cache", {"cache": "device"})):
        net = jx["NCF"](**NCF_ARGS).model
        net.compile(optimizer=jx["Adam"](NCF_LR),
                    loss="sparse_categorical_crossentropy")
        est = net._ensure_estimator(for_training=True)
        est._mesh = jx["Mesh"](np.array(jax.devices()[:1]), ("data",))
        init = jax.device_get(net.get_weights())
        hist = net.fit(x, y, batch_size=NCF_BATCH, nb_epoch=NCF_EPOCHS,
                       shuffle=False, **kw)
        out[mode] = (init, hist, jax.device_get(net.get_weights()))
    return out


@pytest.mark.parametrize("mode", ["loop", "cache"])
def test_ncf_loop_modes_match_jax(jax_ncf_fits, mode):
    init, want, jparams = jax_ncf_fits[mode]
    x, y = _ncf_pairs(NCF_ROWS, 0)
    kw = {"steps_per_loop": 3} if mode == "loop" else {"cache": "device"}
    nets = []
    for extra in (kw, {}):
        net = NeuralCF(**NCF_ARGS).model
        net.module.load_state_dict(flax_to_state_dict(init))
        net.compile(optimizer=Adam(NCF_LR),
                    loss="sparse_categorical_crossentropy", device="cpu")
        nets.append((net, net.fit(x, y, batch_size=NCF_BATCH,
                                  nb_epoch=NCF_EPOCHS, shuffle=False,
                                  **extra)))
    (net, got), (plain, plain_hist) = nets
    assert got == plain_hist
    _same(net.estimator, plain.estimator)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    steps = NCF_EPOCHS * NCF_ROWS // NCF_BATCH
    have = dict(_leaves(state_dict_to_flax(net.module.state_dict(),
                                           jparams)))
    for path, w in _leaves(jparams):
        diff = np.abs(have[path] - w)
        assert np.mean(diff > 1e-5) <= 1e-2, (path, diff.max())
        assert diff.max() <= 2 * NCF_LR * steps, (path, diff.max())


# ---------------------------------------------------- the streaming feed

def test_streaming_scan_matches_per_step():
    prev = OrcaContext.train_data_store
    OrcaContext.train_data_store = "DISK_2"
    try:
        rng = np.random.RandomState(3)
        shards = []
        for _ in range(4):
            x = rng.randn(64, 4).astype(np.float32)
            shards.append({"x": x, "y": (x.sum(1) > 0).astype(np.int32)})
        ds = to_sharded_dataset(HostXShards(shards))
        assert isinstance(ds, StreamingShardedDataset)
        a, b = _est(optimizer="adam"), _est(optimizer="adam")
        ha = a.fit(ds, epochs=3, batch_size=32)
        hb = b.fit(ds, epochs=3, batch_size=32, steps_per_loop=4)
        assert len(hb["loss"]) == 3 and np.isfinite(hb["loss"]).all()
        # 256 rows / 32 per batch = 8 steps an epoch x 3 epochs
        assert b._py_step == 24
        assert ds.peak_window_rows <= 128 + 32
        assert ha == hb
        _same(a, b)
    finally:
        OrcaContext.train_data_store = prev


# ---------------------------------------------------- snapshots, resume

def test_several_iteration_snapshots_at_jax_steps(jx, tmp_path):
    x, y = _cls_data()
    est = _est(str(tmp_path / "t"))
    est.fit((x, y), epochs=2, batch_size=16, shuffle=False,
            steps_per_loop=4, checkpoint_trigger=SeveralIteration(3))
    fnn = jx["fnn"]

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, v, train: bool = False):
            return fnn.Dense(2)(fnn.tanh(fnn.Dense(8)(v)))

    jest = jx["Estimator"].from_flax(
        model=JNet(), loss="sparse_categorical_crossentropy_logits",
        optimizer="sgd", sample_input=x[:2], model_dir=str(tmp_path / "j"))
    jest.fit((x, y), epochs=2, batch_size=16, shuffle=False,
             steps_per_loop=4,
             checkpoint_trigger=jx["SeveralIteration"](3))
    got = sorted(ckpt._list_versions(str(tmp_path / "t")))
    assert got == sorted(ckpt._list_versions(str(tmp_path / "j")))
    assert got == [4, 6, 10, 12]


def test_auto_resume_with_loops_is_bitwise(tmp_path):
    x, y = _reg_data(64)

    def run(faulted, mdir):
        resilience.install_plan("wedge@step:4" if faulted else None)
        est = _est(mdir, loss="mse", optimizer="adam", n_out=1)
        hist = est.fit((x, y), epochs=3, batch_size=16, steps_per_loop=3,
                       checkpoint_trigger=SeveralIteration(3),
                       auto_resume=faulted)
        resilience.install_plan(None)
        return est, hist

    a, ha = run(False, str(tmp_path / "a"))
    b, hb = run(True, str(tmp_path / "b"))
    assert a._py_step == b._py_step == 12 and a._epoch == b._epoch == 3
    assert ha == hb
    _same(a, b)
    for k in ("mu", "nu"):
        for p, q in zip(a._opt_state[k], b._opt_state[k]):
            assert torch.equal(p, q)


# ---------------------------------------------------------- the profiler

def test_profile_window_traces_its_steps(tmp_path):
    x, y = _cls_data()
    est = _est()
    est.set_tensorboard(str(tmp_path), "prof")
    est.fit((x, y), epochs=1, batch_size=16, profile_steps=(2, 5))
    root = tmp_path / "prof" / "train" / "plugins" / "profile"
    files = [p for p in root.rglob("*.json")]
    assert len(files) == 1 and files[0] == \
        type(files[0])(est._profile_window.path)
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    steps = sorted({e["name"] for e in events
                    if str(e.get("name", "")).startswith("zoo_step_")})
    assert steps == ["zoo_step_2", "zoo_step_3", "zoo_step_4"]
    with pytest.raises(ValueError, match="non-empty"):
        est.fit((x, y), epochs=1, batch_size=16, profile_steps=(3, 3))
    # profile=True alone: the default window (0, 20) from this fit's start
    est.fit((x, y), epochs=1, batch_size=16, profile=True)
    assert (est._profile_window.start_step,
            est._profile_window.stop_step) == (6, 26)
    assert os.path.exists(est._profile_window.path)
