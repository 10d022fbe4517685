"""The port's checkpoint triggers (``learn/trigger.py``), a copy of the
JAX package's.

Port counterparts of ``tests/test_estimator.py``'s trigger tests (the
triggers, the score plumbing and its compatibility with 3-argument user
triggers, legacy triggers inside composites, float-score user triggers,
``MaxScore``'s metric and its warnings), and each trigger held to the JAX
one over the same sequence of calls. JAX is imported by fixtures only.
"""

import warnings

import numpy as np
import pytest

from analytics_zoo_tpu_torch.learn import trigger as tt
from analytics_zoo_tpu_torch.learn.estimator import (Estimator,
                                                     _fire_trigger,
                                                     _trigger_needs_score)


@pytest.fixture(scope="module")
def jax_trigger():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.learn import trigger
    return trigger


def test_triggers():
    t = tt.EveryEpoch()
    assert not t(1, 10, 0.5)  # the first observation arms it
    assert not t(1, 20, 0.5) and t(2, 30, 0.5) and not t(2, 40, 0.5)
    s = tt.SeveralIteration(5)
    assert s(0, 5, None) and not s(0, 6, None) and not s(0, 0, None)
    o = tt.TriggerOr(tt.MaxEpoch(3), tt.MinLoss(0.1))
    assert o(3, 0, 1.0) and o(0, 0, 0.05) and not o(1, 0, 1.0)
    assert tt.MaxIteration(4)(0, 4, None) and not tt.MaxIteration(4)(0, 3,
                                                                     None)
    ms = tt.MaxScore(0.7)
    assert ms(0, 0, 1.0, score=0.8) and not ms(0, 0, 1.0, score=0.6)
    assert not ms(0, 0, 1.0)  # no validation score yet: never fires
    assert tt.TriggerOr(tt.MaxScore(0.9), tt.MinLoss(0.1))(0, 0, 0.05,
                                                           score=0.2)
    assert tt.Trigger.get(None) is None and tt.Trigger.get(s) is s
    with pytest.raises(TypeError):
        tt.Trigger.get(5)


def test_trigger_score_plumbing_and_compat(tmp_path):
    class OldStyle(tt.Trigger):          # pre-score 3-arg user subclass
        def __call__(self, epoch, iteration, loss):
            return loss < 0.5

    assert _fire_trigger(OldStyle(), 1, 1, 0.4, score=0.9)
    assert _fire_trigger(tt.MaxScore(0.5), 1, 1, 0.4, score=0.9)
    assert not _fire_trigger(tt.MaxScore(0.5), 1, 1, 0.4, score=None)
    assert _trigger_needs_score(tt.TriggerOr(tt.MinLoss(0.1),
                                             tt.MaxScore(0.5)))
    assert not _trigger_needs_score(tt.MinLoss(0.1))
    # MaxScore without validation_data warns: it can never fire
    from torch import nn
    x = np.random.RandomState(0).randn(32, 4).astype(np.float32)
    y = x.sum(1, keepdims=True).astype(np.float32)
    est = Estimator.from_torch(model=nn.Linear(4, 1), loss="mse",
                               optimizer="sgd", device="cpu",
                               model_dir=str(tmp_path))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        est.fit((x, y), epochs=1, batch_size=32,
                checkpoint_trigger=tt.MaxScore(0.9))
    assert any("MaxScore" in str(r.message) for r in rec)
    assert Estimator.latest_checkpoint(str(tmp_path)) is None


def test_legacy_trigger_nested_in_composites():
    class Legacy(tt.Trigger):
        def __call__(self, epoch, iteration, loss):   # old 3-arg form
            return epoch >= 2

    assert tt.TriggerAnd(Legacy(), tt.MaxScore(0.5))(3, 0, 0.1, score=0.9)
    assert not tt.TriggerAnd(Legacy(), tt.MaxScore(0.5))(1, 0, 0.1,
                                                         score=0.9)
    assert tt.TriggerOr(Legacy(), tt.MaxScore(0.5))(0, 0, 0.1, score=0.9)
    assert not tt.TriggerOr(Legacy(), tt.MaxScore(0.5))(0, 0, 0.1,
                                                        score=0.2)


def test_maxscore_picks_a_named_metric_and_warns_on_error_style():
    ms = tt.MaxScore(0.8, metric="accuracy")
    assert ms(1, 1, 0.3, score={"loss": 0.3, "mse": 5.0, "accuracy": 0.9})
    assert not ms(1, 1, 0.3, score={"loss": 0.3, "accuracy": 0.5})
    assert not ms(1, 1, 0.3, score={"loss": 0.3})     # metric absent
    auto = tt.MaxScore(0.8)
    assert auto(1, 1, 0.3, score={"loss": 0.3, "accuracy": 0.95})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not tt.MaxScore(0.8)(1, 1, 0.3,
                                    score={"loss": 0.3, "mae": 0.1})
        assert any("error-style" in str(x.message) for x in w)


def test_user_float_score_trigger_still_gets_float():
    seen = []

    class UserScore(tt.Trigger):
        def __call__(self, epoch, iteration, loss, score=None):
            seen.append(score)
            return score is not None and score > 0.9

    assert tt.fire(UserScore(), 1, 1, 0.2,
                   score={"loss": 0.2, "accuracy": 0.95})
    assert seen[-1] == 0.95
    # nested: the composite gets the dict, the leaf the float
    assert tt.fire(tt.TriggerOr(UserScore()), 1, 1, 0.2,
                   score={"loss": 0.2, "accuracy": 0.95})
    assert seen[-1] == 0.95


def test_maxscore_named_error_metric_warns_at_construction():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tt.MaxScore(0.1, metric="mse")
        assert any("WORST" in str(x.message) for x in w)


def _build(mod, name):
    return {
        "every_epoch": lambda: mod.EveryEpoch(),
        "several_3": lambda: mod.SeveralIteration(3),
        "max_epoch": lambda: mod.MaxEpoch(2),
        "max_iteration": lambda: mod.MaxIteration(7),
        "min_loss": lambda: mod.MinLoss(0.4),
        "max_score": lambda: mod.MaxScore(0.6, metric="accuracy"),
        "and": lambda: mod.TriggerAnd(mod.MaxEpoch(1), mod.MinLoss(0.5)),
        "or": lambda: mod.TriggerOr(mod.SeveralIteration(4),
                                    mod.MaxScore(0.7)),
    }[name]()


@pytest.mark.parametrize("name", ["every_epoch", "several_3", "max_epoch",
                                  "max_iteration", "min_loss", "max_score",
                                  "and", "or"])
def test_each_trigger_fires_where_the_jax_one_does(jax_trigger, name):
    rng = np.random.RandomState(5)
    calls = [(i // 4, i, float(rng.rand()),
              {"loss": float(rng.rand()), "accuracy": float(rng.rand())})
             for i in range(16)]
    port, ref = _build(tt, name), _build(jax_trigger, name)
    got = [tt.fire(port, *c) for c in calls]
    want = [jax_trigger.fire(ref, *c) for c in calls]
    assert got == want and any(got)
