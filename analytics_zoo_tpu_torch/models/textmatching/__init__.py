from analytics_zoo_tpu_torch.models.textmatching.knrm import (
    KNRM, evaluate_map, evaluate_ndcg,
)

__all__ = ["KNRM", "evaluate_ndcg", "evaluate_map"]
