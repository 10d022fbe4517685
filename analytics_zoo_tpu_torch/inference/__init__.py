from analytics_zoo_tpu_torch.inference.decode_scheduler import (
    DecodeScheduler, PagedKVAllocator, PagedKVCache, PagePoolExhausted)
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel

__all__ = ["InferenceModel", "DecodeScheduler", "PagedKVAllocator",
           "PagedKVCache", "PagePoolExhausted"]
