"""Triggers (ref ``pyzoo/zoo/orca/learn/trigger.py:19-76``, BigDL Trigger).

Counterpart of ``analytics_zoo_tpu/learn/trigger.py``, copied: a trigger
decides when a checkpoint fires, from ``(epoch, iteration, loss)`` and,
where the fit validates, the validation metrics. The estimator evaluates
it on the host from values it already holds, so a trigger never reads the
device.
"""

from __future__ import annotations


class Trigger:
    def __call__(self, epoch: int, iteration: int, loss: float,
                 score: "float | None" = None) -> bool:
        raise NotImplementedError

    @staticmethod
    def get(t):
        if t is None or isinstance(t, Trigger):
            return t
        raise TypeError(f"expected Trigger, got {type(t)}")


def fire(trigger, epoch, iteration, loss, score=None) -> bool:
    """Evaluate a trigger, passing ``score`` only when its ``__call__``
    accepts it — user subclasses written against the old 3-arg signature
    keep working, at the top level AND nested inside composites.

    ``score`` may be the full validation-metrics dict: MaxScore and the
    composites consume it directly; any other trigger gets the first
    non-loss float (the old protocol), so user float-score subclasses
    keep working."""
    import inspect
    if isinstance(score, dict) and \
            not isinstance(trigger, (MaxScore, TriggerAnd, TriggerOr)):
        score = next((v for k, v in score.items() if k != "loss"), None)
    try:
        sig = inspect.signature(trigger.__call__)
        takes_score = ("score" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()))
    except (TypeError, ValueError):
        takes_score = False
    if takes_score:
        return trigger(epoch, iteration, loss, score=score)
    return trigger(epoch, iteration, loss)


class EveryEpoch(Trigger):
    """Fires at each epoch boundary (ref trigger.py:19-31): the first observed
    epoch value arms the trigger; every subsequent epoch *change* fires."""

    def __init__(self):
        self._last_epoch = None

    def __call__(self, epoch, iteration, loss, score=None):
        fired = self._last_epoch is not None and epoch != self._last_epoch
        self._last_epoch = epoch
        return fired


class SeveralIteration(Trigger):
    """Fires every n iterations (ref trigger.py:34-49)."""

    def __init__(self, interval: int):
        assert interval > 0
        self.interval = interval

    def __call__(self, epoch, iteration, loss, score=None):
        return iteration > 0 and iteration % self.interval == 0


class MaxEpoch(Trigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, epoch, iteration, loss, score=None):
        return epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, epoch, iteration, loss, score=None):
        return iteration >= self.max_iteration


class MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, epoch, iteration, loss, score=None):
        return loss is not None and loss < self.min_loss


# validation metrics where LOWER is better — feeding one of these to
# MaxScore's higher-is-better comparison silently inverts the trigger
ERROR_STYLE_METRICS = frozenset(
    {"loss", "mse", "mae", "rmse", "mape", "smape"})


class MaxScore(Trigger):
    """Fires when the validation score exceeds ``max`` (ref
    util/triggers.py:111 MaxScore — accuracy-style metrics where higher
    is better).

    ``metric`` names which validation metric to watch (e.g.
    ``MaxScore(0.9, metric="accuracy")``); without it the estimator's
    first non-loss validation metric feeds the trigger, with a warning
    when that metric is error-style (lower-is-better), where this
    comparison would never fire."""

    def __init__(self, max: float, metric: "str | None" = None):
        self.max = float(max)
        self.metric = metric
        self._warned = False
        if metric in ERROR_STYLE_METRICS:
            import warnings
            warnings.warn(
                f"MaxScore(metric={metric!r}) watches an error-style "
                "(lower-is-better) metric with a higher-is-better "
                "comparison — it would fire on the WORST epochs; use an "
                "accuracy-style metric")

    def __call__(self, epoch, iteration, loss, score=None):
        if isinstance(score, dict):
            if self.metric is not None:
                score = score.get(self.metric)
            else:
                name, score = next(
                    ((k, v) for k, v in score.items() if k != "loss"),
                    (None, None))
                if name in ERROR_STYLE_METRICS and not self._warned:
                    import warnings
                    warnings.warn(
                        f"MaxScore is watching {name!r}, an error-style "
                        "(lower-is-better) metric — the trigger can never "
                        "fire; name an accuracy-style metric with "
                        "MaxScore(..., metric=...)")
                    self._warned = True
        return score is not None and score > self.max


class TriggerAnd(Trigger):
    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, epoch, iteration, loss, score=None):
        # fire() inspects each sub-trigger so legacy 3-arg user triggers
        # work nested, same as at the top level
        return all(fire(t, epoch, iteration, loss, score)
                   for t in self.triggers)


class TriggerOr(Trigger):
    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, epoch, iteration, loss, score=None):
        return any(fire(t, epoch, iteration, loss, score)
                   for t in self.triggers)
