from analytics_zoo_tpu_torch.zouwu.autots.forecast import AutoTSTrainer, TSPipeline

__all__ = ["AutoTSTrainer", "TSPipeline"]
