from analytics_zoo_tpu_torch.keras import layers  # noqa: F401
from analytics_zoo_tpu_torch.keras import regularizers  # noqa: F401
from analytics_zoo_tpu_torch.keras.engine import Input  # noqa: F401
from analytics_zoo_tpu_torch.keras.models import Sequential, Model  # noqa: F401
from analytics_zoo_tpu_torch.keras import policy  # noqa: F401
