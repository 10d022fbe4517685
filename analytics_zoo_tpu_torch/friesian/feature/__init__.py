from analytics_zoo_tpu_torch.friesian.feature.table import (  # noqa: F401
    Table, FeatureTable, StringIndex,
)
