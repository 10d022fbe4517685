"""AutoML — hyperparameter search over trials on the card(s).

Counterpart of ``analytics_zoo_tpu/automl/`` (ref
pyzoo/zoo/automl/search/ray_tune_search_engine.py:36,
pyzoo/zoo/orca/automl/auto_estimator.py:20-125): the sampling DSL
(``hp``), the local search engine (grid × random, bayes, median stopping,
successive halving, trials from a thread pool), the population engine (K
trials in one batched step), ``AutoEstimator`` and the native
gradient-boosted trees.
"""

from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.automl.auto_estimator import AutoEstimator
from analytics_zoo_tpu_torch.automl.metrics import Evaluator
from analytics_zoo_tpu_torch.automl.population import PopulationSearchEngine
from analytics_zoo_tpu_torch.automl.search import (
    BayesSearcher,
    LocalSearchEngine,
    SearchEngine,
    Trial,
)
from analytics_zoo_tpu_torch.automl.xgboost import (
    AutoXGBClassifier,
    AutoXGBoost,
    AutoXGBRegressor,
    XGBClassifier,
    XGBRegressor,
)

__all__ = [
    "hp",
    "AutoEstimator",
    "Evaluator",
    "SearchEngine",
    "LocalSearchEngine",
    "PopulationSearchEngine",
    "BayesSearcher",
    "XGBRegressor",
    "XGBClassifier",
    "AutoXGBRegressor",
    "AutoXGBClassifier",
    "AutoXGBoost",
    "Trial",
]
