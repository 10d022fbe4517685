from analytics_zoo_tpu_torch.net.net import Net
from analytics_zoo_tpu_torch.net.onnx_net import ONNXNet, onnx_to_torch
from analytics_zoo_tpu_torch.net.openvino_net import (OpenVINONet,
                                                      openvino_to_torch)
from analytics_zoo_tpu_torch.net.torch_net import TorchNet, swap_attention

__all__ = ["Net", "ONNXNet", "OpenVINONet", "TorchNet", "onnx_to_torch",
           "openvino_to_torch", "swap_attention"]
