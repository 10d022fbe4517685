"""AutoML: so far the metrics the forecasters report (``metrics.py``);
the search itself is ROADMAP A11."""

from analytics_zoo_tpu_torch.automl.metrics import Evaluator  # noqa: F401
