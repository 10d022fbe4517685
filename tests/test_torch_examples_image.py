"""The port's image and generative examples on the CPU:
``examples_torch/{image_augmentation,image_similarity,vae,
dogs_vs_cats_transfer,object_detection}.py`` run with ``--device cpu``,
all but object_detection in one subprocess, one after another
(``tests/torch_examples.py``), as ``tests/test_examples.py`` runs their
JAX twins; object_detection is marked slow, as JAX's is, and runs
alone.

Each run must exit 0, so its own asserts hold (the transformed shapes,
precision@3 above 0.9, the VAE's loss falling and its reconstruction
error under 0.05, validation accuracy above 0.85, the SSD loss falling),
and print its lines. image_augmentation's transforms are the JAX
package's host code: with Python's ``random`` seeded alike, every image
``ImageSet.get_image`` returns (the random chain, the deterministic
chain and the 3-D crops and rotation) is held to the JAX twin's bitwise,
and so are its printed lines. The other examples' lines depend on each
package's random initialisation and are not compared. JAX runs only in
the ``jax_runs`` fixture, which skips where JAX is absent.
"""

import pytest

from torch_examples import (SLOW, assert_same, check, raises_without_cuda,
                            runner)

SCRIPTS = ["image_augmentation.py", "image_similarity.py", "vae.py",
           "dogs_vs_cats_transfer.py", "object_detection.py"]
TAPS = {"image_augmentation.py": [("images", "feature.image.imageset",
                                   "ImageSet.get_image")]}
LINES = {"image_augmentation.py": ("2d:  8 images augmented to (32, 32, 3)",
                                   "2d deterministic: (40, 40, 3)",
                                   "3d: crop (16, 16, 16)"),
         "image_similarity.py": ("image similarity: precision@3 = ",
                                 "query image class 0"),
         "vae.py": ("VAE: final loss",),
         "dogs_vs_cats_transfer.py": ("dogs-vs-cats transfer: val",),
         "object_detection.py": ("train loss per epoch:",
                                 "detections per image (first 8):",
                                 "VOC mAP@0.5:",
                                 "wrote visualization: det.png")}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return runner(tmp_path_factory, taps=TAPS,
                  batch=[s for s in SCRIPTS if s not in SLOW])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    pytest.importorskip("jax")
    return runner(tmp_path_factory, jax=True, taps=TAPS)


@pytest.mark.parametrize("script", [
    pytest.param(s, marks=pytest.mark.slow) if s in SLOW else s
    for s in SCRIPTS])
def test_example_runs_on_the_cpu(port_runs, script):
    check(port_runs(script), script, *LINES[script])


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_raises_without_cuda(script, monkeypatch):
    raises_without_cuda(script, monkeypatch)


def test_image_augmentation_matches_jax(port_runs, jax_runs):
    mine = port_runs("image_augmentation.py")
    theirs = jax_runs("image_augmentation.py")
    check(theirs, "examples/image_augmentation.py")
    # the 2-D random chain, the deterministic chain, the 3-D crop, the
    # rotation and the centre crop, in the script's order
    assert len(mine.taps["images"]) == 5
    assert_same(mine.taps["images"], theirs.taps["images"], "get_image")
    assert mine.stdout.splitlines() == theirs.stdout.splitlines()
