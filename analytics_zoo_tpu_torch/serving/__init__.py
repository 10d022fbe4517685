from analytics_zoo_tpu_torch.serving.broker import (Broker, BrokerClient,
                                                    ShedError)
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.frontend import FrontEnd
from analytics_zoo_tpu_torch.serving.schema import (DeadlineExpiredError,
                                                    ServingError)

__all__ = ["Broker", "BrokerClient", "ShedError", "InputQueue",
           "OutputQueue", "ClusterServing", "FrontEnd", "ServingError",
           "DeadlineExpiredError"]
