"""Image-classification serving — the reference's headline serving demo
(ref docs ClusterServingGuide: an image-classification model served from
Redis streams, clients enqueueing raw JPEGs that the SERVER decodes and
preprocesses; PreProcessing.scala:36,67-90 + client.py:144).

Here: a model-zoo ``ImageClassifier`` behind the native broker; the client
sends encoded image bytes (or a file path) and the engine runs the
per-model preprocessing preset before inference.

The counterpart of examples/image_classification_serving.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/image_classification_serving.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import io

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from PIL import Image

    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier,
    )
    from analytics_zoo_tpu_torch.models.image.imageclassification. \
        image_classifier import LabelOutput
    from analytics_zoo_tpu_torch.serving import (
        Broker, ClusterServing, InputQueue, OutputQueue, image_pipeline,
    )

    # the real deployment loads torchvision weights:
    #   ImageClassifier(1000, "resnet-50", pretrained="resnet50.pt")
    # (models/migration_image.py documents the state_dict contract); the
    # demo keeps CPU-CI-friendly shapes with a compact backbone
    clf = ImageClassifier(class_num=5, model_name="resnet-lite",
                          image_size=64)
    im = InferenceModel(device=device).load_zoo(clf.model)

    # engine-side chain: resize -> crop to the model's input -> normalize
    from analytics_zoo_tpu_torch.feature.image import (
        ChainedPreprocessing, ImageCenterCrop, ImageChannelNormalize,
        ImageMatToTensor, ImageResize,
    )
    pipe = ChainedPreprocessing([
        ImageResize(72, 72), ImageCenterCrop(64, 64),
        ImageChannelNormalize(127.5, 127.5, 127.5, 127.5, 127.5, 127.5),
        ImageMatToTensor()])

    def preprocess(arr):
        return pipe.transform({"image": np.asarray(arr, np.float32)}
                              )["image"]

    # a full-size deployment would instead use the model-zoo preset:
    assert callable(image_pipeline("resnet-50", source="torchvision"))

    rng = np.random.RandomState(0)
    with Broker.launch() as broker:
        with ClusterServing(im, broker.port, batch_size=4,
                            image_preprocess=preprocess).start() as eng:
            in_q = InputQueue(port=broker.port)
            out_q = OutputQueue(port=broker.port)

            # client sends RAW encoded images — no client-side decode
            uris = []
            for k in range(6):
                raw = (rng.rand(80, 96, 3) * 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(raw).save(buf, format="JPEG", quality=90)
                uris.append(in_q.enqueue(f"img-{k}", image=buf.getvalue()))

            results = out_q.query_many(uris, timeout=60.0)
            assert all(v is not None for v in results.values())

            labels = LabelOutput({i: n for i, n in enumerate(
                ("cat", "dog", "fox", "owl", "yak"))})
            for uri in uris[:3]:
                top = labels(results[uri], top_k=2)[0]
                print(uri, "->", list(zip(top["classes"],
                                          np.round(top["probs"], 3))))
            print("served", eng.metrics()["records_out"], "images")


if __name__ == "__main__":
    main()
