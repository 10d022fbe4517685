"""AutoML in the port against the JAX package's, on the CPU (mirrors
JAX's tests/test_automl.py).

- ``hp``: every sampler, ``sample_config`` and ``grid_points`` give JAX's
  values bit for bit from the same seed.
- The search engines with an analytic builder (no training): the trial
  list, each trial's config, status, metric history and error, the best
  trial and ``trials.json`` (all but ``wall_s``) equal JAX's for grid ×
  random, bayes, median stopping, successive halving, ``n_parallel=2``
  and a raising trial.
- A trial's ``fit_eval`` (an MLP through ``TorchModelBuilder``) from
  JAX's initial weights: the metric within 1e-5 relative (measured
  1.4e-9).
- ``PopulationSearchEngine`` from JAX's initial members (``module.init(
  PRNGKey(seed))``, carried with ``convert``): every member's per-epoch
  metric within 1e-5 relative and the best member's parameters within
  atol 1e-5 (measured: 1.6e-7 apart at worst, metrics and parameters
  alike); one member trained alone from the same start ends within 1e-5
  of the population's (measured: equal).
- The native boosted trees give JAX's predictions bit for bit; the
  AutoXGB search JAX's trials.
- Each entry point raises without CUDA unless ``device="cpu"``.
- ``test_vmapped_population_matches_and_beats_serial`` mirrors JAX's and,
  like it, is slow-marked: it asserts a wall-clock speedup.

JAX is imported by fixtures only.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch.automl import (AutoEstimator, Evaluator,
                                            LocalSearchEngine,
                                            PopulationSearchEngine, hp)
from analytics_zoo_tpu_torch.automl.model_builder import (FlaxModelBuilder,
                                                          TorchModelBuilder)
from analytics_zoo_tpu_torch.common.flax_compat import Dense
from analytics_zoo_tpu_torch.convert import (flax_to_state_dict, member_tree,
                                             stack_trees, state_dict_to_flax)


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "tb"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import flax.linen as fnn
    import jax
    from analytics_zoo_tpu.automl import (AutoXGBRegressor, XGBClassifier,
                                          XGBRegressor)
    from analytics_zoo_tpu.automl import hp as jhp
    from analytics_zoo_tpu.automl import population, search
    from analytics_zoo_tpu.automl.model_builder import FlaxModelBuilder as JB

    class MLP(fnn.Module):
        hidden: int

        @fnn.compact
        def __call__(self, x, train: bool = False):
            x = fnn.relu(fnn.Dense(self.hidden)(x))
            return fnn.Dense(1)(x)

    return dict(jax=jax, hp=jhp, search=search, population=population,
                Builder=JB, MLP=MLP, XGBRegressor=XGBRegressor,
                XGBClassifier=XGBClassifier, AutoXGBRegressor=AutoXGBRegressor)


def linear_data(n=256, d=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = np.arange(1, d + 1, dtype=np.float32)
    y = (x @ w[:, None] + 0.01 * rng.randn(n, 1)).astype(np.float32)
    return x, y


class MLP(nn.Module):
    """JAX's test MLP: ``Dense_0`` (relu) and ``Dense_1`` (flax names)."""

    def __init__(self, hidden: int, d: int = 4):
        super().__init__()
        self.Dense_0 = Dense(d, hidden)
        self.Dense_1 = Dense(hidden, 1)

    def forward(self, x, train: bool = False):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def mlp_creator(config):
    return MLP(int(config.get("hidden", 8)))


# ------------------------------------------------------------------ hp

SPACE = {"a": hp.grid_search([1, 2]), "c": hp.uniform(0, 1),
         "q": hp.quniform(0, 1, 0.25), "lu": hp.loguniform(1e-4, 1e-1),
         "qlu": hp.qloguniform(1e-3, 1.0, 1e-3), "ri": hp.randint(2, 9),
         "qri": hp.qrandint(32, 128, 32), "rn": hp.randn(1.0, 2.0),
         "ch": hp.choice([(16, 16), (30, 30, 30)]),
         "sub": hp.subset(["x", "y", "z", "w"]), "fixed": 0.5,
         "nested": {"k": hp.choice([7, 8])}}


def _jax_space(jhp, space):
    out = {}
    for k, v in space.items():
        if isinstance(v, dict):
            out[k] = _jax_space(jhp, v)
            continue
        name = type(v).__name__
        if name == "GridSearch":
            out[k] = jhp.grid_search(v.grid)
        elif name == "Choice":
            out[k] = jhp.choice(v.categories)
        elif name == "QUniform":
            out[k] = jhp.quniform(v.lower, v.upper, v.q)
        elif name == "Uniform":
            out[k] = jhp.uniform(v.lower, v.upper)
        elif name == "QLogUniform":
            out[k] = jhp.qloguniform(v.lower, v.upper, v.q, v.base)
        elif name == "LogUniform":
            out[k] = jhp.loguniform(v.lower, v.upper, v.base)
        elif name == "QRandInt":
            out[k] = jhp.qrandint(v.lower, v.upper, v.q)
        elif name == "RandInt":
            out[k] = jhp.randint(v.lower, v.upper)
        elif name == "RandN":
            out[k] = jhp.randn(v.mean, v.sd)
        elif name == "Subset":
            out[k] = jhp.subset(v.items, v.min_items)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_config_matches_jax_bitwise(jx, seed):
    jspace = _jax_space(jx["hp"], SPACE)
    assert hp.grid_points(SPACE) == jx["hp"].grid_points(jspace)
    mine, theirs = (np.random.default_rng(seed),
                    np.random.default_rng(seed))
    for gp in hp.grid_points(SPACE) * 20:
        assert hp.sample_config(SPACE, mine, gp) == \
            jx["hp"].sample_config(jspace, theirs, gp)


class TestHp:
    def test_samplers_in_range(self):
        rng = np.random.default_rng(0)
        for _ in range(50):
            assert hp.choice([1, 2, 3]).sample(rng) in (1, 2, 3)
            assert 0.0 <= hp.uniform(0, 1).sample(rng) <= 1.0
            v = hp.loguniform(1e-4, 1e-1).sample(rng)
            assert 1e-4 <= v <= 1e-1
            assert 2 <= hp.randint(2, 5).sample(rng) < 5
        q = hp.quniform(0, 1, 0.25).sample(rng)
        assert abs(q / 0.25 - round(q / 0.25)) < 1e-9

    def test_grid_cross_product(self):
        space = {"a": hp.grid_search([1, 2]), "b": hp.grid_search([10, 20]),
                 "c": hp.uniform(0, 1)}
        pts = hp.grid_points(space)
        assert {(p["a"], p["b"]) for p in pts} == {(1, 10), (1, 20),
                                                  (2, 10), (2, 20)}
        cfg = hp.sample_config(space, np.random.default_rng(0), pts[0])
        assert cfg["a"] == pts[0]["a"] and 0 <= cfg["c"] <= 1

    def test_fixed_values_pass_through(self):
        cfg = hp.sample_config({"lr": 0.1, "nested": {"k": hp.choice([7])}},
                               np.random.default_rng(0))
        assert cfg["lr"] == 0.1 and cfg["nested"]["k"] == 7

    def test_subset_sampler(self):
        rng = np.random.default_rng(0)
        items = ["a", "b", "c", "d"]
        for _ in range(30):
            s = hp.subset(items).sample(rng)
            assert 1 <= len(s) <= 4
            assert s == [it for it in items if it in s]
        assert len(hp.subset(items, min_items=3).sample(rng)) >= 3
        with pytest.raises(ValueError):
            hp.subset(["a"], min_items=2)


class TestEvaluator:
    def test_metrics(self):
        y = np.array([1.0, 2.0, 3.0])
        p = np.array([1.0, 2.0, 4.0])
        assert Evaluator.evaluate("mse", y, p) == pytest.approx(1 / 3)
        assert Evaluator.evaluate("rmse", y, p) == pytest.approx(
            np.sqrt(1 / 3))
        assert Evaluator.get_metric_mode("r2") == "max"
        with pytest.raises(ValueError):
            Evaluator.evaluate("nope", y, p)


# ------------------------------------------- engines, analytic builder

class _AnalyticBuilder:
    """JAX's test builder: ``fit_eval`` returns a known function of the
    config and epoch (no training), so both packages' engines can be held
    to each other exactly."""

    def __init__(self, fn):
        self.fn = fn

    def build(self, config):
        builder = self

        class _M:
            def __init__(self):
                self.epoch = 0

            def fit_eval(self, data, validation_data=None, epochs=1,
                         metric="mse", batch_size=None):
                self.epoch += epochs
                return builder.fn(dict(config), self.epoch)

            def save(self, path):
                pass

        return _M()


def _bayes_obj(cfg, epoch):
    return abs(np.log10(cfg["lr"]) - np.log10(3e-3)) + 0.01 * cfg["k"]


def _poison(cfg, epoch):
    if cfg["lr"] > 1e-2:
        raise RuntimeError("diverged")
    return float(cfg["lr"])


def _rate(cfg, epoch):
    return 10.0 / (1.0 + cfg["rate"] * epoch)


def _noisy(cfg, epoch):
    return float(cfg["x"]) * (1 + 0.3 * np.sin(epoch * cfg["x"] * 7)) / epoch


RATES = [0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0]
CASES = {
    "grid_random": (_noisy, lambda h: {"x": h.uniform(0.1, 2.0),
                                       "g": h.grid_search([1, 2, 3]),
                                       "c": h.choice(["a", "b"])},
                    dict(n_sampling=2, epochs=3), {}),
    "bayes": (_bayes_obj, lambda h: {"lr": h.loguniform(1e-5, 1e-1),
                                     "k": h.randint(0, 4),
                                     "opt": h.choice(["adam", "sgd"])},
              dict(n_sampling=14, epochs=1, search_alg="bayes"), {}),
    "bayes_median": (_noisy, lambda h: {"x": h.uniform(0.1, 2.0)},
                     dict(n_sampling=8, epochs=3, search_alg="bayes",
                          scheduler="median"), {}),
    "median": (_noisy, lambda h: {"x": h.uniform(0.1, 2.0)},
               dict(n_sampling=10, epochs=4, scheduler="median"), {}),
    "halving": (_rate, lambda h: {"rate": h.grid_search(RATES)},
                dict(n_sampling=1, epochs=9, scheduler="hyperband"), {}),
    "parallel": (_noisy, lambda h: {"x": h.uniform(0.1, 2.0),
                                    "g": h.grid_search([1, 2])},
                 dict(n_sampling=3, epochs=2), {"n_parallel": 2}),
    "poison": (_poison, lambda h: {"lr": h.loguniform(1e-4, 1.0)},
               dict(n_sampling=12, epochs=1, search_alg="bayes"), {}),
}


def _summary(path):
    with open(os.path.join(path, "trials.json")) as f:
        rows = json.load(f)
    for r in rows:
        r.pop("wall_s")
    return rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_exactly(jx, tmp_path, case):
    fn, space_of, kw, eng_kw = CASES[case]
    mine = LocalSearchEngine(_AnalyticBuilder(fn), logs_dir=str(tmp_path),
                             name="port", seed=5, device="cpu", **eng_kw)
    mine.compile((None, None), space_of(hp), metric="mse", mode="min", **kw)
    theirs = jx["search"].LocalSearchEngine(
        _AnalyticBuilder(fn), logs_dir=str(tmp_path), name="jax", seed=5,
        **eng_kw)
    theirs.compile((None, None), space_of(jx["hp"]), metric="mse",
                   mode="min", **kw)
    got, want = mine.run(), theirs.run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.trial_id, a.config, a.status, a.metric_history,
                a.best_metric, a.error) == \
            (b.trial_id, b.config, b.status, b.metric_history,
             b.best_metric, b.error)
    assert _summary(mine.logs_dir) == _summary(theirs.logs_dir)
    if case == "poison":
        assert any(t.status == "error" for t in got)
    if case == "halving":
        assert sum(t.status == "stopped" for t in got) >= 5
    if case == "median":
        assert any(t.status == "stopped" for t in got)
    assert mine.get_best_trial().trial_id == theirs.get_best_trial().trial_id


def test_all_trials_failing_raises_like_jax(tmp_path):
    def bad_creator(config):
        raise RuntimeError("boom")
    eng = LocalSearchEngine(TorchModelBuilder(bad_creator, device="cpu"),
                            logs_dir=str(tmp_path), name="bad", device="cpu")
    x, y = linear_data(32)
    eng.compile((x, y), {"lr": 1e-2}, epochs=1)
    trials = eng.run()
    assert trials[0].status == "error" and "boom" in trials[0].error
    with pytest.raises(RuntimeError):
        eng.get_best_trial()


# ------------------------------------------------- training trial models

def test_trial_fit_eval_matches_jax_from_its_weights(jx, tmp_path, orca_ctx):
    x, y = linear_data(128)
    cfg = {"hidden": 8, "lr": 1e-2, "batch_size": 32}
    jm = jx["Builder"](lambda c: jx["MLP"](hidden=c["hidden"])).build(cfg)
    jm._ensure(x)
    sd = flax_to_state_dict(jx["jax"].device_get(jm._est.adapter.params))

    def creator(c):
        m = mlp_creator(c)
        m.load_state_dict(sd)
        return m

    pm = TorchModelBuilder(creator, device="cpu").build(cfg)
    for _ in range(2):
        got = pm.fit_eval((x, y), (x[:64], y[:64]), metric="mse")
        want = jm.fit_eval((x, y), (x[:64], y[:64]), metric="mse")
        assert got == pytest.approx(want, rel=1e-5)


def test_flax_builder_name_and_restore(tmp_path):
    assert FlaxModelBuilder is TorchModelBuilder
    x, y = linear_data(128)
    eng = LocalSearchEngine(TorchModelBuilder(mlp_creator, device="cpu"),
                            logs_dir=str(tmp_path), name="t", device="cpu")
    eng.compile((x, y), {"hidden": hp.grid_search([4, 16]),
                         "lr": hp.choice([1e-2]), "batch_size": 64},
                n_sampling=1, epochs=2, metric="mse")
    trials = eng.run()
    assert [t.status for t in trials] == ["done", "done"]
    assert all(len(t.metric_history) == 2 for t in trials)
    assert (tmp_path / "t" / "trials.json").exists()
    best = eng.get_best_trial()
    model = eng.builder.build(best.config)
    model.restore(best.checkpoint)
    assert model.evaluate(x, y)["mse"] == pytest.approx(best.best_metric,
                                                        rel=1e-5)


def test_parallel_trials_equal_serial(tmp_path):
    """n_parallel=2 runs the trials from a thread pool; every trial ends
    with the metric history it has alone, dropout included (the fits draw
    under RNG_LOCK): within 1e-6 relative, phase 20(e)'s limit (measured:
    equal)."""
    x, y = linear_data(128)

    class DropMLP(MLP):
        def forward(self, x, train: bool = False):
            h = torch.nn.functional.dropout(torch.relu(self.Dense_0(x)), 0.3,
                                            training=train)
            return self.Dense_1(h)

    space = {"hidden": hp.grid_search([4, 8, 16, 32]), "lr": 1e-2,
             "batch_size": 32}
    runs = []
    for n_par in (1, 2):
        eng = LocalSearchEngine(
            TorchModelBuilder(lambda c: DropMLP(c["hidden"]), device="cpu"),
            logs_dir=str(tmp_path), name=f"p{n_par}", n_parallel=n_par,
            device="cpu")
        eng.compile((x, y), space, n_sampling=1, epochs=2, metric="mse")
        runs.append([t.metric_history for t in eng.run()])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6, atol=0)


# ---------------------------------------------------------- population

def _jax_creator(jx, x):
    """An MLP(8) creator that loads JAX's initial parameters for
    ``config["seed"]``, as the JAX population inits member k."""
    m = jx["MLP"](hidden=8)

    def creator(config):
        net = MLP(8)
        net.load_state_dict(flax_to_state_dict(jx["jax"].device_get(
            m.init(jx["jax"].random.PRNGKey(int(config["seed"])), x[:1])
            ["params"])))
        return net

    return creator


def test_population_matches_jax(jx, tmp_path, orca_ctx):
    x, y = linear_data(256)
    space = {"lr": hp.loguniform(1e-4, 3e-2),
             "weight_decay": hp.uniform(0.0, 1e-2)}
    theirs = jx["population"].PopulationSearchEngine(
        lambda c: jx["MLP"](hidden=8), logs_dir=str(tmp_path), seed=3)
    theirs.compile((x, y), _jax_space(jx["hp"], space), n_sampling=6,
                   epochs=3, metric="mse", batch_size=64,
                   validation_data=(x[:100], y[:100]))
    want = theirs.run()
    mine = PopulationSearchEngine(_jax_creator(jx, x),
                                  logs_dir=str(tmp_path), seed=3,
                                  device="cpu")
    mine.compile((x, y), space, n_sampling=6, epochs=3, metric="mse",
                 batch_size=64, validation_data=(x[:100], y[:100]))
    assert [t.config for t in mine.trials] == [t.config for t in want]
    got = mine.run()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.metric_history, b.metric_history,
                                   rtol=1e-5)
        assert a.status == b.status == "done"
    assert mine.get_best_trial().trial_id == theirs.get_best_trial().trial_id
    jbest = jx["jax"].device_get(theirs.get_best_params())["params"]
    mbest = state_dict_to_flax(mine.get_best_params(), jbest)
    for layer in jbest:
        for leaf in jbest[layer]:
            np.testing.assert_allclose(mbest[layer][leaf],
                                       jbest[layer][leaf], rtol=0, atol=1e-5)
    # the stacked members cross packages one tree per member
    stacked = stack_trees([state_dict_to_flax(mine.member_state_dict(k),
                                              jbest) for k in range(6)])
    assert stacked["Dense_0"]["kernel"].shape == (6, 4, 8)
    np.testing.assert_array_equal(member_tree(stacked, mine.get_best_trial()
                                              .trial_id)["Dense_1"]["bias"],
                                  mbest["Dense_1"]["bias"])


def test_population_member_equals_member_alone(tmp_path):
    x, y = linear_data(256)
    pop = PopulationSearchEngine(mlp_creator, logs_dir=str(tmp_path),
                                 seed=1, device="cpu")
    pop.compile((x, y), {"lr": hp.loguniform(1e-4, 3e-2)}, n_sampling=4,
                epochs=2, batch_size=64)
    pop.run()
    # the same start: member 2 is built from its config's seed
    alone = PopulationSearchEngine(mlp_creator, logs_dir=str(tmp_path),
                                   name="alone", seed=1, device="cpu")
    alone.compile((x, y), {"lr": pop.trials[2].config["lr"],
                           "seed": pop.trials[2].config["seed"]},
                  n_sampling=1, epochs=2, batch_size=64)
    alone.run()
    a, b = pop.member_state_dict(2), alone.member_state_dict(0)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_batched_adamw_is_adamw_per_member():
    """Three steps of the population's AdamW over stacked members equal
    learn.optimizers' AdamWeightDecay (optax adamw, eps 1e-8) run on each
    member with its own rate and decay: bitwise on the CPU."""
    from analytics_zoo_tpu_torch.automl.population import BatchedAdamW
    from analytics_zoo_tpu_torch.learn.optimizers import AdamWeightDecay
    rng = np.random.default_rng(7)
    lr, wd = [3e-2, 1e-3, 2e-4], [0.0, 1e-2, 5e-3]
    shapes = {"w": (4, 3), "b": (3,)}
    params = {n: torch.from_numpy(rng.normal(size=(3,) + s)
                                  .astype(np.float32))
              for n, s in shapes.items()}
    grads = [{n: torch.from_numpy(rng.normal(size=(3,) + s)
                                  .astype(np.float32) * 10.0 ** -i)
              for n, s in shapes.items()} for i in range(3)]
    plain = [[params[n][k].clone() for n in shapes] for k in range(3)]
    opt = BatchedAdamW(params, torch.tensor(lr), torch.tensor(wd))
    for g in grads:
        opt.step(params, g)
    for k in range(3):
        one = AdamWeightDecay(lr[k], wd[k], epsilon=1e-8)
        state = one.init(plain[k])
        for i, g in enumerate(grads):
            one.step(plain[k], [g[n][k] for n in shapes], state, i)
        for n, p in zip(shapes, plain[k]):
            np.testing.assert_array_equal(params[n][k].numpy(), p.numpy(),
                                          err_msg=f"{n} member {k}")


def test_population_rejects_structural_axes(tmp_path):
    eng = PopulationSearchEngine(mlp_creator, logs_dir=str(tmp_path),
                                 device="cpu")
    with pytest.raises(ValueError, match="structural"):
        eng.compile(linear_data(16), {"lr": hp.choice([1e-3]),
                                      "hidden": hp.choice([4, 8])})


@pytest.mark.slow  # ~20s: trains the full population twice (vmap+serial)
def test_vmapped_population_matches_and_beats_serial(tmp_path):
    import time
    x, y = linear_data(256)
    K, E = 32, 6
    # torch.func's first vmap imports torch._dynamo and sympy (about 4 s,
    # once a process): a one-member run pays it before the clock starts
    warm = PopulationSearchEngine(mlp_creator, logs_dir=str(tmp_path),
                                  name="warm", device="cpu")
    warm.compile((x[:64], y[:64]), {"lr": 1e-3}, n_sampling=1)
    warm.run()
    eng = PopulationSearchEngine(mlp_creator, loss="mse",
                                 logs_dir=str(tmp_path), seed=3, device="cpu")
    eng.compile((x, y), {"lr": hp.loguniform(1e-4, 3e-2)}, n_sampling=K,
                epochs=E, metric="mse", batch_size=64)
    t0 = time.time()
    trials = eng.run()
    pop_wall = time.time() - t0
    assert all(t.status == "done" and len(t.metric_history) == E
               for t in trials)
    metrics = np.array([t.best_metric for t in trials])
    assert np.isfinite(metrics).all()
    assert len(set(np.round(metrics, 6))) > 1, "members identical"
    assert eng.get_best_trial().best_metric < np.var(y)
    serial = LocalSearchEngine(TorchModelBuilder(mlp_creator, device="cpu"),
                               logs_dir=str(tmp_path), name="serial", seed=3,
                               device="cpu")
    serial.compile((x, y), {"lr": hp.loguniform(1e-4, 3e-2),
                            "batch_size": 64},
                   n_sampling=K, epochs=E, metric="mse")
    t0 = time.time()
    serial.run()
    speedup = (time.time() - t0) / max(pop_wall, 1e-9)
    print(f"population packing speedup: {speedup:.2f}x")
    assert speedup > 1.2, f"population packing only {speedup:.1f}x vs serial"


# ------------------------------------------------------- AutoEstimator

class TestAutoEstimator:
    def test_fit_search_restores_best(self, tmp_path):
        x, y = linear_data()
        auto = AutoEstimator.from_torch(model_creator=mlp_creator,
                                        logs_dir=str(tmp_path), name="mlp",
                                        device="cpu")
        assert AutoEstimator.from_flax is AutoEstimator.from_torch
        auto.fit((x, y), validation_data=(x, y),
                 search_space={"hidden": hp.choice([8, 32]),
                               "lr": hp.loguniform(1e-3, 1e-2),
                               "batch_size": 64},
                 n_sampling=2, epochs=3, metric="mse")
        assert auto.get_best_config()["hidden"] in (8, 32)
        mse = auto.get_best_model().evaluate(x, y, metrics=["mse"])["mse"]
        assert mse == pytest.approx(auto.get_best_trial().best_metric,
                                    rel=1e-5)

    def test_from_keras_builder(self, tmp_path):
        from analytics_zoo_tpu_torch.keras.layers import Dense as KDense
        from analytics_zoo_tpu_torch.keras.models import Sequential

        def creator(config):
            m = Sequential()
            m.add(KDense(int(config["hidden"]), activation="relu",
                         input_shape=(4,)))
            m.add(KDense(1))
            m.compile(optimizer="adam", loss="mse", device="cpu")
            return m

        x, y = linear_data(128)
        auto = AutoEstimator.from_keras(model_creator=creator,
                                        logs_dir=str(tmp_path), name="k",
                                        device="cpu")
        auto.fit((x, y), search_space={"hidden": hp.choice([8])},
                 n_sampling=1, epochs=2, metric="mse", batch_size=64)
        assert auto.get_best_trial().status == "done"


def test_entry_points_need_cuda_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves")
    for make in (lambda: PopulationSearchEngine(mlp_creator),
                 lambda: LocalSearchEngine(TorchModelBuilder(mlp_creator)),
                 lambda: AutoEstimator.from_torch(model_creator=mlp_creator)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# ------------------------------------------------------------ XGBoost

def test_native_booster_matches_jax_bitwise(jx):
    from analytics_zoo_tpu_torch.automl import XGBClassifier, XGBRegressor
    rng = np.random.RandomState(0)
    x = rng.rand(300, 3).astype(np.float32)
    y = np.sin(4 * x[:, 0]) + (x[:, 1] > 0.5) * 2 + x[:, 2] ** 2
    kw = dict(n_estimators=20, max_depth=4, learning_rate=0.2,
              subsample=0.8, seed=3)
    np.testing.assert_array_equal(XGBRegressor(**kw).fit(x, y).predict(x),
                                  jx["XGBRegressor"](**kw).fit(x, y)
                                  .predict(x))
    yc = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.int64)
    np.testing.assert_array_equal(
        XGBClassifier(**kw).fit(x, yc).predict_proba(x),
        jx["XGBClassifier"](**kw).fit(x, yc).predict_proba(x))


class TestXGBoost:
    def test_regressor_learns_nonlinear(self):
        from analytics_zoo_tpu_torch.automl import XGBRegressor
        rng = np.random.RandomState(0)
        x = rng.rand(400, 3).astype(np.float32)
        y = (np.sin(4 * x[:, 0]) + (x[:, 1] > 0.5) * 2 + x[:, 2] ** 2)
        m = XGBRegressor(n_estimators=60, max_depth=4, learning_rate=0.2)
        m.fit(x[:300], y[:300])
        mse = m.evaluate(x[300:], y[300:], metrics=["mse"])["mse"]
        assert mse < 0.1 * np.var(y[300:])

    def test_classifier_and_proba(self):
        from analytics_zoo_tpu_torch.automl import XGBClassifier
        rng = np.random.RandomState(1)
        x = rng.rand(400, 4).astype(np.float32)
        y = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.int64)
        m = XGBClassifier(n_estimators=60, max_depth=4, learning_rate=0.3)
        m.fit(x[:300], y[:300])
        assert (m.predict(x[300:]) == y[300:]).mean() > 0.9
        proba = m.predict_proba(x[300:])
        assert proba.shape == (100, 2)
        np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-6)

    def test_auto_xgb_search_matches_jax(self, jx, tmp_path):
        from analytics_zoo_tpu_torch.automl import AutoXGBRegressor
        rng = np.random.RandomState(2)
        x = rng.rand(256, 3).astype(np.float32)
        y = x[:, 0] * 3 + (x[:, 1] > 0.3)
        space = {"max_depth": hp.grid_search([2, 4]),
                 "learning_rate": hp.choice([0.1, 0.3])}
        autos = []
        for cls, h, name in ((AutoXGBRegressor, hp, "port"),
                             (jx["AutoXGBRegressor"], jx["hp"], "jax")):
            auto = cls(logs_dir=str(tmp_path), name=name, n_estimators=30)
            auto.fit((x[:192], y[:192]), validation_data=(x[192:], y[192:]),
                     search_space=_jax_space(h, space), n_sampling=1,
                     metric="mse")
            autos.append(auto)
        assert autos[0].get_best_config() == autos[1].get_best_config()
        np.testing.assert_array_equal(
            autos[0].get_best_model().predict(x[192:]),
            autos[1].get_best_model().predict(x[192:]))
        assert np.mean((autos[0].get_best_model().predict(x[192:])
                        - y[192:]) ** 2) < 0.1 * np.var(y)
