"""Image augmentation, 2D and 3D (mirrors ref apps/image-augmentation +
apps/image-augmentation-3d: build a transformer chain, run it over an
ImageSet, inspect the results).

The 2D chain is the reference's classic augmentation stack (resize,
random crop, flip, color jitter, normalize); the 3D section exercises the
volumetric ops (crop/rotate/affine) the reference implements in
``zoo/.../feature/image3d/``.

The counterpart of examples/image_augmentation.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/image_augmentation.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.feature.image import (
        ChainedPreprocessing, ImageBrightness, ImageCenterCrop,
        ImageChannelNormalize, ImageColorJitter, ImageHFlip, ImageMirror,
        ImageRandomCrop, ImageRandomPreprocessing, ImageResize, ImageSet,
        ImageSetToSample, PerImageNormalize,
    )
    from analytics_zoo_tpu_torch.feature.image3d import (
        CenterCrop3D, RandomCrop3D, Rotate3D,
    )

    init_orca_context(cluster_mode="local", device=device)
    try:
        rng = np.random.RandomState(0)
        images = [rng.randint(0, 255, (48, 64, 3), dtype=np.uint8)
                  for _ in range(8)]

        # --- 2D augmentation chain (ref apps/image-augmentation) ---
        pipeline = ChainedPreprocessing([
            ImageResize(36, 36),
            ImageRandomCrop(32, 32),
            ImageRandomPreprocessing(ImageHFlip(), prob=0.5),
            ImageColorJitter(),
            ImageBrightness(-16, 16),
            ImageChannelNormalize(123, 117, 104, 58, 57, 57),
            ImageSetToSample(),
        ])
        iset = ImageSet.from_arrays(images, labels=list(range(8)))
        out = iset.transform(pipeline)
        aug = out.get_image()
        print("2d: ", len(aug), "images augmented to",
              aug[0].shape, aug[0].dtype)
        assert all(im.shape == (32, 32, 3) for im in aug)

        # deterministic ops compose too
        det = ImageSet.from_arrays(images).transform(ChainedPreprocessing([
            ImageMirror(), ImageCenterCrop(40, 40), PerImageNormalize(0, 1),
        ]))
        m = det.get_image()[0]
        print("2d deterministic:", m.shape,
              f"range=[{m.min():.2f},{m.max():.2f}]")

        # --- 3D augmentation (ref apps/image-augmentation-3d) ---
        vols = [rng.rand(24, 24, 24).astype(np.float32) for _ in range(4)]
        vset = ImageSet.from_arrays(vols)
        cropped = vset.transform(RandomCrop3D(16, 16, 16)).get_image()
        assert all(v.shape[:3] == (16, 16, 16) for v in cropped)
        rotated = vset.transform(
            Rotate3D([0.0, 0.0, np.pi / 6])).get_image()
        centered = vset.transform(CenterCrop3D(12, 12, 12)).get_image()
        print("3d: crop", cropped[0].shape[:3], "rotate",
              rotated[0].shape[:3], "center-crop", centered[0].shape[:3])
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
