"""Mixture of experts against the JAX package, on the CPU (mirrors JAX
``tests/test_moe.py``).

- ``top_k_gating``: JAX's checks (slots exclusive, combine weights the
  gates, overflow dropped), and against JAX's on the same logits: the
  dispatch bitwise, the combine weights and the aux loss within 1e-6
  (torch's and XLA's ``exp`` round a gate 1 ulp apart now and then, about
  6e-8).
- ``MoEModule``: JAX's parameters carried across (``convert.py`` keeps
  ``gate``, ``w1``, ``b1``, ``w2``, ``b2``); the forward and every
  gradient within 1e-5 of flax's.
- The estimator consumes the load-balance loss times ``aux_loss_weight``
  as JAX's train step does: the fits with weight 0 and 1 within 1e-5 of
  JAX's, loss and parameters.
- Expert parallelism across gloo ranks (``parallel/launch.py``): "ep2"
  over 2 ranks, "ep4" and "dp2,ep2" over 4, with ``ep_param_rules`` (each
  rank holds ``E / ep`` experts, the tokens reach them by all_to_all):
  the fit's losses, the first step's aux loss and every parameter within
  1e-5 of JAX's "dp2,ep4" on its 8 virtual devices, from the same
  parameters.
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import flax_to_state_dict
from analytics_zoo_tpu_torch.ops.moe import (MoEModule, ep_param_rules,
                                             top_k_gating)
from analytics_zoo_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_multirank_workers.py")
E, DM, DH = 4, 32, 64
BATCH, EPOCHS = 16, 2


@pytest.fixture(autouse=True)
def _tmp_log_dir(tmp_path, monkeypatch):
    """The in-process fits' summaries go to the test's own directory."""
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "tb"))


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from analytics_zoo_tpu.ops import moe as jmoe
    return jax, jnp, jmoe


def test_dispatch_slots_are_exclusive():
    logits = torch.from_numpy(np.random.RandomState(0).randn(32, 4)
                              .astype(np.float32))
    d, _, aux = top_k_gating(logits, k=2, capacity=16)
    assert d.sum(0).max() <= 1.0 + 1e-6
    assert d.sum((1, 2)).max() <= 2.0 + 1e-6
    assert torch.isfinite(aux)


def test_combine_weights_match_gates():
    logits = torch.from_numpy(np.random.RandomState(1).randn(16, 4)
                              .astype(np.float32))
    probs = torch.softmax(logits, -1)
    _, c, _ = top_k_gating(logits, k=1, capacity=16)
    top = probs.argmax(-1)
    for n in range(16):
        np.testing.assert_allclose(float(c[n].sum()),
                                   float(probs[n, top[n]]), rtol=1e-5)


def test_capacity_drops_overflow():
    logits = torch.tensor(np.tile([10.0, 0.0], (8, 1)).astype(np.float32))
    d, _, _ = top_k_gating(logits, k=1, capacity=2)
    assert float(d[:, 0].sum()) == 2.0


@pytest.mark.parametrize("k, n, e, capacity", [(1, 64, 4, 20),
                                               (2, 64, 4, 20),
                                               (2, 512, 8, 100),
                                               (1, 512, 8, 80)])
def test_gating_matches_jax(jx, k, n, e, capacity):
    _, jnp, jmoe = jx
    logits = np.random.RandomState(k * n).randn(n, e).astype(np.float32)
    jd, jc, ja = jmoe.top_k_gating(jnp.asarray(logits), k, capacity)
    td, tc, ta = top_k_gating(torch.from_numpy(logits), k, capacity)
    assert np.array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


def _jax_module(jx):
    jax, _, jmoe = jx
    m = jmoe.MoEModule(n_experts=E, d_model=DM, d_hidden=DH, k=2)
    x = np.random.RandomState(0).randn(4, 6, DM).astype(np.float32)
    return m, m.init(jax.random.PRNGKey(0), x), x


def test_module_forward_and_grads_match_jax(jx):
    jax, jnp, _ = jx
    m, variables, x = _jax_module(jx)
    params = jax.device_get(variables["params"])

    def loss(p):
        return (m.apply({"params": p}, x) ** 2).mean()
    want = np.asarray(m.apply(variables, x))
    want_g = jax.device_get(jax.grad(loss)(variables["params"]))
    t = MoEModule(E, DM, DH, k=2)
    t.load_state_dict(flax_to_state_dict(params))
    got = t(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5)
    (got ** 2).mean().backward()
    for name, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=0,
                                   atol=1e-5, err_msg=name)
    assert float(p.grad.abs().max()) > 0


def _data():
    rng = np.random.RandomState(1)
    x = rng.randn(64, DM).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int32)


def _jax_net(jx):
    import flax.linen as fnn
    _, _, jmoe = jx

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            h = jmoe.MoEModule(n_experts=E, d_model=DM, d_hidden=DH,
                               name="moe")(x, train=train)
            return fnn.Dense(2)(h)
    return Net()


def _jax_fit(jx, aux_w, strategy="dp", opt="sgd"):
    jax, _, _ = jx
    from analytics_zoo_tpu.common import context as jctx
    from analytics_zoo_tpu.learn.estimator import Estimator as JEst
    jctx.stop_orca_context()
    jctx.init_orca_context(cluster_mode="local")
    try:
        x, y = _data()
        est = JEst.from_flax(
            model=_jax_net(jx), loss="sparse_categorical_crossentropy_logits",
            optimizer=opt, sample_input=x[:2], seed=0, aux_loss_weight=aux_w,
            strategy=strategy,
            param_rules=ep_param_rules() if "ep" in strategy else None)
        init = jax.device_get(est.adapter.params)
        hist = est.fit((x, y), epochs=EPOCHS, batch_size=BATCH,
                       shuffle=False)
        return init, hist["loss"], jax.device_get(est._state["params"])
    finally:
        jctx.stop_orca_context()


@pytest.mark.parametrize("aux_w", [0.0, 1.0])
def test_aux_loss_consumed_by_train_step(jx, aux_w):
    """JAX ``test_aux_loss_consumed_by_train_step``: the reported loss
    includes the weighted aux term and the gate learns from it."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_multirank_workers import MoENet
    from analytics_zoo_tpu_torch.learn import Estimator
    init, want_loss, want = _jax_fit(jx, aux_w)
    net = MoENet(E, DM, DH)
    net.load_state_dict(flax_to_state_dict(init))
    est = Estimator.from_torch(
        model=net, loss="sparse_categorical_crossentropy_logits",
        optimizer="sgd", seed=0, device="cpu")
    est.aux_loss_weight = aux_w
    x, y = _data()
    hist = est.fit((x, y), epochs=EPOCHS, batch_size=BATCH, shuffle=False)
    np.testing.assert_allclose(hist["loss"], want_loss, rtol=0, atol=1e-5)
    got = est.model.state_dict()
    for k, v in flax_to_state_dict(want).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def ep_runs(jx):
    init, loss, params = _jax_fit(jx, 0.01, strategy="dp2,ep4", opt="adam")
    x, y = _data()
    case = {"dims": [E, DM, DH], "k": 2, "opt": "adam", "aux_weight": 0.01,
            "batch": BATCH, "epochs": EPOCHS, "x": x.tolist(),
            "y": y.tolist(),
            "params": {k: {kk: np.asarray(vv).tolist() for kk, vv in
                           v.items()} for k, v in init.items()}}
    runs = {}
    for world, strats in ((2, ["ep2"]), (4, ["ep4", "dp2,ep2"])):
        res = launch(f"{WORKERS}:moe_fit", world, args=(
            [dict(case, name=s, strategy=s) for s in strats],))
        for s in strats:
            runs[s] = [r[s] for r in res]
    return {"jax": (loss, params), "port": runs}


@pytest.mark.parametrize("strategy", ["ep2", "ep4", "dp2,ep2"])
def test_expert_parallel_training_matches_jax(ep_runs, strategy):
    want_loss, want = ep_runs["jax"]
    ranks = ep_runs["port"][strategy]
    got = ranks[0]
    assert all(r["loss"] == got["loss"] for r in ranks)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=0, atol=1e-5)
    assert got["covered"] == ["moe.b1", "moe.b2", "moe.w1", "moe.w2"]
    for k, v in flax_to_state_dict(want).items():
        np.testing.assert_allclose(np.asarray(got["params"][k]), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    # each rank's experts took a share of the dispatched tokens
    assert all(r["dispatched"] > 0 for r in ranks)


def test_ep_aux_loss_is_global(ep_runs):
    """The aux loss of the first step is the global batch's on every rank
    of every layout."""
    auxes = [r["aux"] for runs in ep_runs["port"].values() for r in runs]
    np.testing.assert_allclose(auxes, auxes[0], rtol=0, atol=1e-6)


def test_ep_param_rules_are_jax(jx):
    _, _, jmoe = jx
    assert ep_param_rules() == jmoe.ep_param_rules()
