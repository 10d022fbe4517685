from analytics_zoo_tpu_torch.keras2 import layers  # noqa: F401
