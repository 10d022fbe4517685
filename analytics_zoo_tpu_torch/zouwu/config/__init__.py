from analytics_zoo_tpu_torch.zouwu.config.recipe import (
    BayesRecipe,
    GridRandomRecipe,
    LSTMGridRandomRecipe,
    LSTMSeq2SeqRandomRecipe,
    MTNetGridRandomRecipe,
    MTNetSmokeRecipe,
    PastSeqParamHandler,
    RandomRecipe,
    Recipe,
    Seq2SeqRandomRecipe,
    SmokeRecipe,
    TCNGridRandomRecipe,
    TCNSmokeRecipe,
    XgbRegressorGridRandomRecipe,
    XgbRegressorSkOptRecipe,
)

__all__ = [
    "Recipe", "SmokeRecipe", "MTNetSmokeRecipe", "TCNSmokeRecipe",
    "PastSeqParamHandler", "GridRandomRecipe", "LSTMGridRandomRecipe",
    "LSTMSeq2SeqRandomRecipe", "Seq2SeqRandomRecipe", "TCNGridRandomRecipe",
    "MTNetGridRandomRecipe", "RandomRecipe", "BayesRecipe",
    "XgbRegressorGridRandomRecipe", "XgbRegressorSkOptRecipe",
]
