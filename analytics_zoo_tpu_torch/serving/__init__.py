from analytics_zoo_tpu_torch.serving.broker import (Broker, BrokerClient,
                                                    ShedError)
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.config import ServingConfig
from analytics_zoo_tpu_torch.serving.engine import ClusterServing, image_pipeline
from analytics_zoo_tpu_torch.serving.frontend import FrontEnd
from analytics_zoo_tpu_torch.serving.schema import (DeadlineExpiredError,
                                                    ServingError)

__all__ = ["Broker", "BrokerClient", "ShedError", "InputQueue",
           "OutputQueue", "ServingConfig", "ClusterServing", "FrontEnd",
           "image_pipeline", "ServingError", "DeadlineExpiredError"]
