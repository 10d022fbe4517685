from analytics_zoo_tpu_torch.serving.broker import Broker, BrokerClient
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.schema import ServingError

__all__ = ["Broker", "BrokerClient", "InputQueue", "OutputQueue",
           "ClusterServing", "ServingError"]
