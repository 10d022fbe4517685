from analytics_zoo_tpu_torch.parallel.mesh import build_mesh, get_default_mesh  # noqa: F401
from analytics_zoo_tpu_torch.parallel.sharded_executable import ShardedExecutable  # noqa: F401
from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy  # noqa: F401
