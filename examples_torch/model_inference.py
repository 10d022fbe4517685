"""Model inference service patterns on the PyTorch port (the counterpart
of examples/model_inference.py; ref apps/model-inference-examples +
apps/tfnet): load models from several sources into InferenceModel,
predict concurrently, and quantize for serving.

The reference holds ``concurrentNum`` copies of a TF/OpenVINO model in a
JVM queue; here ONE module on the device serves all threads (weights live
once on the device) and int8 weight-only quantization stands in for the
OpenVINO int8 path.

    python examples_torch/model_inference.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import concurrent.futures as futures

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    import torch
    import torch.nn as tnn

    from analytics_zoo_tpu_torch import (OrcaContext, init_orca_context,
                                         stop_orca_context)
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.inference.quantize import resident_bytes
    from analytics_zoo_tpu_torch.models import TextClassifier

    # full fp32 products: the loaded module is held to torch's forward
    # on the host within JAX's 1e-4, which TF32 (the default precision's
    # products on the card) does not meet
    precision = OrcaContext.default_matmul_precision
    OrcaContext.default_matmul_precision = "float32"
    init_orca_context(cluster_mode="local", device=device)
    try:
        rng = np.random.RandomState(0)

        # --- 1. zoo model → InferenceModel (ref doLoadBigDL path) ---
        clf = TextClassifier(class_num=3, vocab_size=100, token_length=16,
                             sequence_length=24, encoder="cnn",
                             encoder_output_dim=32)
        tokens = rng.randint(1, 101, (64, 24)).astype(np.float32)
        im = InferenceModel(concurrent_num=4, device=device).load_zoo(clf)
        probs = im.predict(tokens)
        print("zoo model:", probs.shape, "rows sum to",
              round(float(np.asarray(probs).sum(-1).mean()), 4))

        # concurrent callers share the module on the device
        with futures.ThreadPoolExecutor(max_workers=4) as ex:
            outs = list(ex.map(lambda i: im.predict(tokens[i::4]),
                               range(4)))
        assert sum(len(o) for o in outs) == 64
        print("served 4 concurrent callers")

        # --- 2. a torch module built in place (ref doLoadTensorflow
        # saved-model path; JAX loads a flax module here) ---
        class MLP(tnn.Module):
            def __init__(self):
                super().__init__()
                self.hidden = tnn.Linear(8, 32)
                self.out = tnn.Linear(32, 2)

            def forward(self, x):
                return self.out(torch.relu(self.hidden(x)))

        feats = rng.randn(16, 8).astype(np.float32)
        im2 = InferenceModel(device=device).load_torch(MLP(), feats[:1])
        print("module:", im2.predict(feats).shape)

        # --- 3. torch module (ref doLoadPyTorch path) ---
        tm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                 torch.nn.Linear(16, 2))
        im3 = InferenceModel(device=device).load_torch(tm, feats[:1])
        torch_out = tm(torch.from_numpy(feats)).detach().numpy()
        np.testing.assert_allclose(im3.predict(feats), torch_out,
                                   atol=1e-4)
        print("torch model loaded; outputs match torch")

        # --- 4. int8 quantization (ref OpenVINO int8 calibration) ---
        before = np.asarray(im.predict(tokens))
        nbytes = resident_bytes(im._module)
        im.quantize()
        after = np.asarray(im.predict(tokens))
        shrink = nbytes / resident_bytes(im._module)
        agree = (before.argmax(-1) == after.argmax(-1)).mean()
        print(f"quantized: {shrink:.1f}x smaller, "
              f"top-1 agreement {agree:.0%}")
        assert agree >= 0.98
    finally:
        stop_orca_context()
        OrcaContext.default_matmul_precision = precision


if __name__ == "__main__":
    main()
