"""Net — unified model import (ref zoo/.../pipeline/api/Net.scala:446 and
pyzoo/zoo/pipeline/api/net/net_load.py:69).

Counterpart of ``analytics_zoo_tpu/net/net.py``. Every import lands on the
card (``device``, ``cuda`` unless given; raises without CUDA):

- ``Net.load(path)``        — a saved ZooModel directory
- ``Net.load_torch(module)``— a live torch ``nn.Module`` (``TorchNet``)
- ``Net.load_torch_file(path)`` — a ``torch.save``'d module
- ``Net.load_onnx(path)``   — an ONNX file, parsed without the onnx
  package (``ONNXNet``)
- ``Net.load_openvino(model_path, weight_path)`` — an OpenVINO IR, parsed
  without the openvino package (``OpenVINONet``)
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.common.device import DeviceLike


class Net:
    @staticmethod
    def load(path: str):
        from analytics_zoo_tpu_torch.models.common import ZooModel
        return ZooModel.load_model(path)

    @staticmethod
    def load_torch(module, device: DeviceLike = None) -> "TorchNet":
        from analytics_zoo_tpu_torch.net.torch_net import TorchNet
        return TorchNet(module, device=device)

    @staticmethod
    def load_torch_file(path: str, device: DeviceLike = None):
        """A ``torch.save``'d whole module (ref Net.loadTorch, Net.scala)."""
        import torch
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if not hasattr(obj, "forward"):
            raise ValueError(
                f"{path} holds a {type(obj).__name__}, not a torch module; "
                "for state_dicts load the module yourself and call load_torch")
        from analytics_zoo_tpu_torch.net.torch_net import TorchNet
        return TorchNet(obj, device=device)

    @staticmethod
    def load_onnx(path: str, device: DeviceLike = None):
        """ONNX import (ref pyzoo onnx_loader.py:141): the ONNX protobuf
        parsed directly and run op by op with torch (net/onnx_net.py)."""
        from analytics_zoo_tpu_torch.net.onnx_net import ONNXNet
        return ONNXNet(path, device=device)

    @staticmethod
    def load_openvino(model_path: str, weight_path: str,
                      device: DeviceLike = None):
        """OpenVINO IR import (ref InferenceModel.load_openvino /
        inferenceModelLoadOpenVINO): the IR xml+bin parsed directly and run
        layer by layer with torch (net/openvino_net.py)."""
        from analytics_zoo_tpu_torch.net.openvino_net import OpenVINONet
        return OpenVINONet(model_path, weight_path, device=device)
