"""The port's 3-D volume transforms (``feature/image3d``) against the JAX
package's, on the CPU: host numpy copies, so each transform's output is
JAX's bit for bit on the same volume (``[D, H, W]`` and ``[D, H, W, C]``),
the random crop's after the same ``random.seed``, and a chain (``>``)
equals JAX's chain. JAX is imported by fixtures only."""

import random

import numpy as np
import pytest

from analytics_zoo_tpu_torch.feature import image3d as t3


@pytest.fixture(scope="module")
def j3():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.feature import image3d
    return image3d


def _vol(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _flow(shape, seed=1):
    return np.random.RandomState(seed).randn(3, *shape) * 1.5


CASES = {
    "Crop3D": lambda m: m.Crop3D([1, 2, 0], [3, 4, 5]),
    "CenterCrop3D": lambda m: m.CenterCrop3D(3, 4, 5),
    "RandomCrop3D": lambda m: m.RandomCrop3D(3, 4, 5),
    "AffineTransform3D": lambda m: m.AffineTransform3D(
        np.array([[1.0, 0.1, 0.0], [0.0, 0.9, 0.2], [0.1, 0.0, 1.1]]),
        translation=np.array([0.5, -1.0, 0.25])),
    "AffineTransform3D_padding": lambda m: m.AffineTransform3D(
        np.eye(3) * 1.3, clamp_mode="padding", pad_val=-1.0),
    "Rotate3D": lambda m: m.Rotate3D([0.3, -0.2, 0.5]),
    "Rotate3D_padding": lambda m: m.Rotate3D([1.0, 0.4, -0.7],
                                             clamp_mode="padding"),
    "Warp3D_offset": lambda m: m.Warp3D(_flow((6, 7, 8))),
    "Warp3D_absolute": lambda m: m.Warp3D(
        np.abs(_flow((6, 7, 8))) * 2, offset=False, clamp_mode="padding",
        pad_val=0.5),
}


@pytest.mark.parametrize("channels", [None, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_is_jax_bitwise(j3, name, channels):
    shape = (6, 7, 8) + ((channels,) if channels else ())
    vol = _vol(shape)
    random.seed(7)
    got = CASES[name](t3)({"image": vol})["image"]
    random.seed(7)
    want = CASES[name](j3)({"image": vol})["image"]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_chain_and_rotation_matrix_are_jax(j3):
    vol = _vol((8, 8, 8), seed=3)
    random.seed(11)
    got = (t3.Rotate3D([0.2, 0.1, 0.0]) > t3.RandomCrop3D(4, 5, 6))(
        {"image": vol})["image"]
    random.seed(11)
    want = (j3.Rotate3D([0.2, 0.1, 0.0]) > j3.RandomCrop3D(4, 5, 6))(
        {"image": vol})["image"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t3.rotation_matrix(0.3, -0.2, 0.5),
                                  j3.rotation_matrix(0.3, -0.2, 0.5))


def test_errors_are_jax(j3):
    for m in (t3, j3):
        with pytest.raises(ValueError, match="exceeds"):
            m.Crop3D([4, 0, 0], [3, 3, 3]).apply_image(_vol((6, 6, 6)))
        with pytest.raises(ValueError, match="volume"):
            m.CenterCrop3D(2, 2, 2).apply_image(_vol((6, 6)))
        with pytest.raises(ValueError, match="clamp_mode"):
            m.AffineTransform3D(np.eye(3), clamp_mode="wrap")
        with pytest.raises(ValueError, match="flow_field"):
            m.Warp3D(np.zeros((2, 3, 3, 3)))
