from analytics_zoo_tpu_torch.common.context import (  # noqa: F401
    init_orca_context,
    stop_orca_context,
    OrcaContext,
)
