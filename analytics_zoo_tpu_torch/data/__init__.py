from analytics_zoo_tpu_torch.data.dataset import (  # noqa: F401
    ShardedDataset, to_sharded_dataset,
)
from analytics_zoo_tpu_torch.data.shard import (  # noqa: F401
    HostXShards, XShards,
)
