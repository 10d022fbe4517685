from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel

__all__ = ["InferenceModel"]
