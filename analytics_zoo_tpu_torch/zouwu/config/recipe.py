"""Recipes — named search-space presets for AutoTS.

The port's copy of ``analytics_zoo_tpu/zouwu/config/recipe.py`` over the
port's ``automl.hp``: the same spaces, so a seed draws the same configs.

API-parity with ``zoo.zouwu.config.recipe`` (ref
pyzoo/zoo/zouwu/config/recipe.py, 724 LoC: SmokeRecipe, GridRandomRecipe,
LSTMGridRandomRecipe, Seq2SeqRandomRecipe, TCNGridRandomRecipe,
MTNetGridRandomRecipe — each a ``search_space()`` + trial-count/stop
settings consumed by the search engine).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.automl import hp


class Recipe:
    """A search space + trial budget."""

    num_samples: int = 1
    epochs: int = 1
    search_alg: "str | None" = None

    def search_space(self, all_available_features=None) -> dict:
        raise NotImplementedError

    def runtime_params(self) -> dict:
        return {"n_sampling": self.num_samples, "epochs": self.epochs,
                "search_alg": self.search_alg}


class SmokeRecipe(Recipe):
    """One tiny config — CI smoke (ref recipe.py SmokeRecipe)."""

    num_samples = 1
    epochs = 2

    def search_space(self, all_available_features=None):
        return {
            "model": "VanillaLSTM",
            "past_seq_len": 12,
            "lstm_units": (16, 16),
            "dropouts": (0.1, 0.1),
            "lr": 1e-2,
            "batch_size": 32,
        }


class MTNetSmokeRecipe(Recipe):
    """One tiny MTNet config — CI smoke (ref recipe.py MTNetSmokeRecipe)."""

    num_samples = 1
    epochs = 2

    def search_space(self, all_available_features=None):
        return {
            "model": "MTNet",
            "long_series_num": 2,
            "series_length": 4,
            "ar_window": 2,
            "lr": 1e-2,
            "batch_size": 32,
        }


class TCNSmokeRecipe(Recipe):
    """One tiny TCN config — CI smoke (ref recipe.py TCNSmokeRecipe)."""

    num_samples = 1
    epochs = 2

    def search_space(self, all_available_features=None):
        return {
            "model": "TCN",
            "past_seq_len": 12,
            "num_channels": (16, 16),
            "kernel_size": 3,
            "lr": 1e-2,
            "batch_size": 32,
        }


class PastSeqParamHandler:
    """Spell a look_back spec as an hp axis (ref recipe.py:93)."""

    @staticmethod
    def get_past_seq_config(look_back):
        if isinstance(look_back, (tuple, list)):
            if len(look_back) != 2 or look_back[1] < look_back[0]:
                raise ValueError(
                    "look_back should be an int or an ordered (min, max) "
                    f"tuple, got {look_back!r}")
            return hp.randint(look_back[0], look_back[1] + 1)
        return look_back


class GridRandomRecipe(Recipe):
    """Grid over model family x random draws of its hyperparameters
    (ref recipe.py GridRandomRecipe)."""

    def __init__(self, num_rand_samples: int = 1, epochs: int = 2,
                 look_back: "int | tuple" = 24):
        self.num_samples = num_rand_samples
        self.epochs = epochs
        self.look_back = look_back

    def _past_seq(self):
        return PastSeqParamHandler.get_past_seq_config(self.look_back)

    @staticmethod
    def _features_axis(space: dict, all_available_features):
        """Add the feature-selection axis when the caller supplies the
        available names (ref recipes: 'selected_features':
        RandomSample(all_available_features))."""
        if all_available_features:
            space["selected_features"] = hp.subset(all_available_features)
        return space

    def search_space(self, all_available_features=None):
        return self._features_axis({
            "model": hp.grid_search(["VanillaLSTM", "TCN"]),
            "past_seq_len": self._past_seq(),
            "lstm_units": hp.choice([(16, 16), (32, 32)]),
            "dropouts": (0.2, 0.2),
            "num_channels": hp.choice([(16, 16), (30, 30, 30)]),
            "kernel_size": hp.choice([2, 3]),
            "lr": hp.loguniform(1e-3, 1e-2),
            "batch_size": hp.choice([32, 64]),
        }, all_available_features)


class LSTMGridRandomRecipe(GridRandomRecipe):
    """(ref recipe.py LSTMGridRandomRecipe)"""

    def search_space(self, all_available_features=None):
        return self._features_axis({
            "model": "VanillaLSTM",
            "past_seq_len": self._past_seq(),
            "lstm_units": hp.choice([(16, 16), (32, 32), (64, 64)]),
            "dropouts": hp.choice([(0.1, 0.1), (0.2, 0.2)]),
            "lr": hp.loguniform(1e-3, 1e-2),
            "batch_size": hp.choice([32, 64]),
        }, all_available_features)


class TCNGridRandomRecipe(GridRandomRecipe):
    """(ref recipe.py TCNGridRandomRecipe)"""

    def search_space(self, all_available_features=None):
        return self._features_axis({
            "model": "TCN",
            "past_seq_len": self._past_seq(),
            "num_channels": hp.choice([(16, 16), (30, 30, 30)]),
            "kernel_size": hp.grid_search([2, 3]),
            "lr": hp.loguniform(1e-3, 1e-2),
            "batch_size": hp.choice([32, 64]),
        }, all_available_features)


class Seq2SeqRandomRecipe(GridRandomRecipe):
    """(ref recipe.py Seq2SeqRandomRecipe)"""

    def search_space(self, all_available_features=None):
        return self._features_axis({
            "model": "Seq2Seq",
            "past_seq_len": self._past_seq(),
            "latent_dim": hp.choice([32, 64, 128]),
            "dropout": hp.uniform(0.0, 0.3),
            "lr": hp.loguniform(1e-3, 1e-2),
            "batch_size": hp.choice([32, 64]),
        }, all_available_features)


class LSTMSeq2SeqRandomRecipe(GridRandomRecipe):
    """Random draws across both LSTM and Seq2Seq families
    (ref recipe.py LSTMSeq2SeqRandomRecipe)."""

    def search_space(self, all_available_features=None):
        return self._features_axis({
            "model": hp.grid_search(["VanillaLSTM", "Seq2Seq"]),
            "past_seq_len": self._past_seq(),
            "lstm_units": hp.choice([(16, 16), (32, 32), (64, 64)]),
            "dropouts": hp.choice([(0.1, 0.1), (0.2, 0.2)]),
            "latent_dim": hp.choice([32, 64, 128]),
            "dropout": hp.uniform(0.0, 0.3),
            "lr": hp.loguniform(1e-3, 1e-2),
            "batch_size": hp.choice([32, 64]),
        }, all_available_features)


class MTNetGridRandomRecipe(GridRandomRecipe):
    """(ref recipe.py MTNetGridRandomRecipe)"""

    def search_space(self, all_available_features=None):
        # MTNet's window is (long_series_num + 1) * series_length, so the
        # lookback is spelled by those two — no past_seq_len axis here
        return self._features_axis({
            "model": "MTNet",
            "long_series_num": hp.choice([2, 4]),
            "series_length": hp.choice([4, 8]),
            "lr": hp.loguniform(1e-3, 1e-2),
            "batch_size": hp.choice([32, 64]),
        }, all_available_features)


class RandomRecipe(GridRandomRecipe):
    """Pure random search, no grid axes (ref recipe.py RandomRecipe)."""

    def __init__(self, num_rand_samples: int = 1, epochs: int = 5,
                 look_back: "int | tuple" = 24):
        super().__init__(num_rand_samples, epochs, look_back)

    def search_space(self, all_available_features=None):
        return self._features_axis({
            "model": hp.choice(["VanillaLSTM", "TCN"]),
            "past_seq_len": self._past_seq(),
            "lstm_units": hp.choice([(16, 16), (32, 32), (64, 64)]),
            "dropouts": hp.uniform(0.0, 0.3),
            "num_channels": hp.choice([(16, 16), (30, 30, 30)]),
            "kernel_size": hp.choice([2, 3, 5]),
            "lr": hp.loguniform(1e-4, 1e-1),
            "batch_size": hp.qrandint(32, 128, 32),
        }, all_available_features)


class BayesRecipe(Recipe):
    """Search space shaped for the bayes (TPE-style) search alg — continuous
    axes only, consumed with ``search_alg="bayes"``
    (ref recipe.py BayesRecipe, skopt BayesOptSearch there)."""

    search_alg = "bayes"

    def __init__(self, num_samples: int = 1, epochs: int = 5,
                 look_back: "int | tuple" = 24):
        self.num_samples = num_samples
        self.epochs = epochs
        self.look_back = look_back

    def search_space(self, all_available_features=None):
        return {
            "model": "TCN",
            "past_seq_len":
                PastSeqParamHandler.get_past_seq_config(self.look_back),
            "num_channels": hp.choice([(16, 16), (30, 30, 30)]),
            "kernel_size": hp.randint(2, 6),
            "lr": hp.loguniform(1e-4, 1e-1),
            "batch_size": hp.qrandint(32, 128, 32),
        }


class XgbRegressorGridRandomRecipe(Recipe):
    """Search space for AutoXGBRegressor (ref recipe.py
    XgbRegressorGridRandomRecipe)."""

    def __init__(self, num_rand_samples: int = 1):
        self.num_samples = num_rand_samples

    def search_space(self, all_available_features=None):
        return {
            "n_estimators": hp.grid_search([50, 100]),
            "max_depth": hp.grid_search([2, 4]),
            "min_child_weight": hp.choice([1, 2, 3]),
            "learning_rate": hp.loguniform(1e-3, 1e-1),
        }


class XgbRegressorSkOptRecipe(Recipe):
    """Continuous XGB space for the bayes search alg (ref recipe.py
    XgbRegressorSkOptRecipe, skopt there)."""

    search_alg = "bayes"

    def __init__(self, num_rand_samples: int = 10):
        self.num_samples = num_rand_samples

    def search_space(self, all_available_features=None):
        return {
            "n_estimators": hp.randint(5, 10),
            "max_depth": hp.randint(2, 5),
        }
