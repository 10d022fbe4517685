"""The port's ``config.yaml`` surface (serving/config.py) and its
entry point (``python -m analytics_zoo_tpu_torch.serving.start``), on
the CPU.

``ServingConfig.load`` equals the JAX package's on the same files, with
PyYAML and with the built-in reader forced (the card's machine has no
PyYAML); the entry point boots broker, engine and frontend from one file
in a subprocess and answers a ``POST /predict`` bitwise the direct
predict. JAX is imported inside tests only."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.config import (ServingConfig,
                                                    _mini_yaml, load_yaml)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "full": ("model:\n  path: /models/ncf  # a zoo model\n"
             "data:\n  src: 10.0.0.5:7000\n  stream: s1\n"
             "  result_key: r1\n  record_encrypted: false\n"
             "params:\n  batch_size: 32\n"),
    "defaults": "model:\n  path: m\n",
    "quoted": ("model:\n  path: \"/a b/c\"\n"
               "data:\n  src: 'localhost:6400'\nparams:\n  batch_size: 1\n"),
    "preprocessing": ("model:\n  path: m\npreprocessing:\n  resize: 256\n"
                      "  crop: 224\n  mean: 0.485,0.456,0.406\n"
                      "  scale: 0.5\n"),
}


def _write(tmp_path, text):
    p = tmp_path / "config.yaml"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("reader", ["pyyaml", "mini"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_equals_jax(tmp_path, monkeypatch, name, reader):
    from analytics_zoo_tpu.serving.config import \
        ServingConfig as JServingConfig
    if reader == "mini":
        monkeypatch.setitem(sys.modules, "yaml", None)   # ImportError
    path = _write(tmp_path, CONFIGS[name])
    got = dataclasses.asdict(ServingConfig.load(path))
    want = dataclasses.asdict(JServingConfig.load(path))
    assert got == want
    assert got["model_path"]


def test_mini_reader_matches_pyyaml_on_the_serving_shape(tmp_path):
    pytest.importorskip("yaml")
    for text in CONFIGS.values():
        path = _write(tmp_path, text)
        mini = _mini_yaml(open(path).read())
        assert mini == load_yaml(path)


def test_encrypted_records_and_preprocessing_name_their_item(tmp_path):
    """``record_encrypted: true`` still names ROADMAP A11; the
    ``preprocessing:`` section builds the engine's image chain, which
    equals JAX's on an image; no section builds none."""
    from analytics_zoo_tpu.serving.config import \
        ServingConfig as JServingConfig
    with pytest.raises(ValueError, match="record_encrypted.*A11"):
        ServingConfig.load(_write(
            tmp_path, "model:\n  path: m\ndata:\n  record_encrypted: true\n"))
    path = _write(tmp_path, CONFIGS["preprocessing"])
    cfg = ServingConfig.load(path)
    assert cfg.image_resize == 256 and cfg.image_crop == 224
    img = (np.random.RandomState(0).rand(300, 260, 3) * 255).astype(
        np.uint8)
    got = cfg.build_image_preprocess()(img)
    want = JServingConfig.load(path).build_image_preprocess()(img)
    assert got.shape == (224, 224, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert ServingConfig.load(_write(
        tmp_path, CONFIGS["defaults"])).build_image_preprocess() is None


def test_start_boots_from_config_and_serves_a_record(tmp_path):
    """The entry point in a subprocess on the CPU: it launches the broker
    its ``src`` names, serves a POST /predict bitwise the direct predict,
    and stops on SIGTERM with exit 0."""
    import socket

    import torch

    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF

    torch.manual_seed(0)
    model_dir = str(tmp_path / "model")
    NeuralCF(user_count=5, item_count=5, class_num=2, user_embed=4,
             item_embed=4, hidden_layers=(8,), include_mf=False,
             mf_embed=0).save_model(model_dir)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        bport = s.getsockname()[1]
    cfg = _write(tmp_path, f"model:\n  path: {model_dir}\n"
                           f"data:\n  src: 127.0.0.1:{bport}\n"
                           f"params:\n  batch_size: 4\n")
    env = dict(os.environ, HTTP_PORT="0", BIND_HOST="127.0.0.1",
               ZOO_FLEET_HEARTBEAT_S="0.25",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.start",
         cfg, "--device", "cpu", "--broker", "python"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("replica "):
                return

    try:
        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(120)
        up = [ln for ln in lines if ln.startswith("serving up")]
        assert up and f"broker 127.0.0.1:{bport}" in up[0], lines
        hport = int(up[0].rsplit(":", 1)[1])
        x = np.array([2.0, 3.0], np.float32)
        want = InferenceModel(device="cpu").load(model_dir).predict(
            np.stack([x] * 4), batch_size=4)[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{hport}/predict",
            data=json.dumps({"uri": "cfg0", "inputs": {
                "x": schema.encode_tensor(x)}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        np.testing.assert_array_equal(
            schema.decode_tensor(out["result"]), want)
        with urllib.request.urlopen(f"http://127.0.0.1:{hport}/healthz",
                                    timeout=30) as resp:
            hz = json.loads(resp.read())
        assert hz["fleet"]["replicas"] == 1
        assert hz["backend"]["platform"] == "cpu"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert time.monotonic() - t0 < 60
