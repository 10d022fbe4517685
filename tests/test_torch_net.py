"""The port's ``net/torch_net.py`` (``TorchNet``, ``Net.load_torch*``, the
attention swap) and JAX's checkpoint names for ``Estimator.from_torch``
(ROADMAP A13, ``convert.torch_tree_plan``), against the JAX package, on
the CPU.

- ``TorchNet.params`` equals JAX's ``torch_to_jax`` tree (keys, shapes,
  values bitwise) for an MLP with a nested Sequential, conv + BatchNorm +
  Linear, a 2-layer LSTM and a GRU passed bare, an MHA user with both
  ``batch_first`` settings and a 2-layer ``TransformerEncoder`` (d 64, 4
  heads); ``predict`` within 1e-5 of JAX's translation (fp32; the
  encoder's relu, as JAX maps ``F.gelu`` to its tanh approximation).
- The swap (ROADMAP C30): each ``nn.MultiheadAttention`` of JAX's domain
  calls ``ops.attention.dot_product_attention`` once a forward where JAX's
  rule does (unread weights, ``need_weights=False``, the encoder layers
  despite torch's fused fast path), and torch's own attention where the
  weights are read or a mask is passed; ``InferenceModel.load_torch``
  swaps too; ResNet-50's torch twin is served bitwise itself.
- A13: a JAX ``Estimator.from_torch`` snapshot (parameters, Adam's
  moments, BatchNorm statistics) restores in the port's ``Estimator`` and
  ``InferenceModel.load_checkpoint``, and the port's in JAX, bitwise.
JAX is imported by fixtures only.
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.net import Net, TorchNet
from analytics_zoo_tpu_torch.net.torch_net import FlashMultiheadAttention


@pytest.fixture(autouse=True)
def _logs_in_tmp(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def jt():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.learn.estimator import Estimator
    from analytics_zoo_tpu.learn.optimizers import Adam
    from analytics_zoo_tpu.net.torch_net import torch_to_jax
    return dict(jax=jax, torch_to_jax=torch_to_jax, Estimator=Estimator,
                Adam=Adam)


class ConvBN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.bn = nn.BatchNorm2d(4)
        self.head = nn.Linear(4 * 8 * 8, 2)

    def forward(self, x):
        return self.head(torch.flatten(torch.relu(self.bn(self.conv(x))),
                                       1))


class AttnUser(nn.Module):
    def __init__(self, batch_first):
        super().__init__()
        self.attn = nn.MultiheadAttention(16, 4, batch_first=batch_first)
        self.out = nn.Linear(16, 3)

    def forward(self, x):
        y, _ = self.attn(x, x, x)
        return self.out(y)


class ReadsWeights(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(16, 4, batch_first=True)

    def forward(self, x):
        y, w = self.attn(x, x, x)
        return y + w.sum()


def _encoder():
    layer = nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0,
                                       batch_first=True)
    return nn.TransformerEncoder(layer, 2, enable_nested_tensor=False)


def _seeded(make, seed=0):
    torch.manual_seed(seed)
    m = make()
    for mod in m.modules():
        if isinstance(mod, nn.BatchNorm2d):
            with torch.no_grad():
                mod.running_mean.uniform_(-1, 1)
                mod.running_var.uniform_(0.5, 2)
    return m.eval()


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = {
    "mlp": (lambda: nn.Sequential(nn.Linear(6, 8), nn.ReLU(),
                                  nn.Sequential(nn.Linear(8, 3), nn.Tanh())),
            (4, 6)),
    "conv_bn": (ConvBN, (2, 3, 8, 8)),
    "lstm": (lambda: nn.LSTM(5, 7, num_layers=2, batch_first=True),
             (2, 4, 5)),
    "gru": (lambda: nn.GRU(5, 7), (4, 2, 5)),
    "mha_batch_first": (lambda: AttnUser(True), (2, 6, 16)),
    "mha_seq_first": (lambda: AttnUser(False), (6, 2, 16)),
    "encoder": (_encoder, (2, 10, 64)),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", sorted(CASES))
def test_params_and_predict_match_jax(jt, name):
    make, shape = CASES[name]
    m = _seeded(make)
    apply_fn, variables = jt["torch_to_jax"](copy.deepcopy(m))
    net = TorchNet(m, device="cpu")
    want = dict(_leaves(variables["params"]))
    got = dict(_leaves(net.params))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bufs = convert.torch_to_jax_tree(m)["buffers"]
    assert sorted(dict(_leaves(bufs))) == \
        sorted(dict(_leaves(variables["buffers"])))
    x = _x(*shape)
    np.testing.assert_allclose(_first(net.predict(x)),
                               np.asarray(_first(apply_fn(variables, x))),
                               rtol=1e-5, atol=1e-5)


def _count_core(monkeypatch):
    from analytics_zoo_tpu_torch.ops import attention
    calls = []
    real = attention.dot_product_attention

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(attention, "dot_product_attention", counted)
    return calls


@pytest.mark.parametrize("name, core_calls", [
    ("mha_batch_first", 1), ("mha_seq_first", 1), ("encoder", 2),
    ("reads_weights", 0)])
def test_the_swap_takes_the_core_where_jax_does(monkeypatch, name,
                                                core_calls):
    make, shape = CASES.get(name, (ReadsWeights, (2, 6, 16)))
    m = _seeded(make)
    calls = _count_core(monkeypatch)
    net = TorchNet(m, device="cpu")
    assert net.swapped == (2 if name == "encoder" else 1)
    x = _x(*shape)
    got = _first(net.predict(x))
    assert len(calls) == core_calls
    with torch.no_grad():
        want = _first(m(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the user's module is untouched
    assert not any(isinstance(s, FlashMultiheadAttention)
                   for s in m.modules())


def test_masks_and_other_configs_stay_torch(monkeypatch):
    calls = _count_core(monkeypatch)
    m = _seeded(_encoder)
    net = TorchNet(m, device="cpu")
    x = torch.from_numpy(_x(2, 10, 64))
    mask = torch.zeros(2, 10, dtype=torch.bool)
    mask[:, -3:] = True
    with torch.inference_mode():
        got = net.module(x, src_key_padding_mask=mask)
        want = m(x, src_key_padding_mask=mask)
    assert calls == []
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    kv = nn.MultiheadAttention(16, 4, kdim=8, vdim=8, batch_first=True)
    bias_kv = nn.MultiheadAttention(16, 4, add_bias_kv=True)
    for mod in (kv, bias_kv):
        assert TorchNet(mod, device="cpu").swapped == 0


def test_inference_model_load_torch_swaps(monkeypatch):
    calls = _count_core(monkeypatch)
    m = _seeded(_encoder)
    x = _x(3, 10, 64)
    im = InferenceModel(device="cpu").load_torch(m, x)
    got = im.predict(x)
    assert len(calls) == 2
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resnet50_twin_is_served_as_itself():
    from analytics_zoo_tpu_torch.models.migration_image import \
        make_torch_resnet50
    m = _seeded(lambda: make_torch_resnet50(class_num=10))
    net = Net.load_torch(m, device="cpu")
    assert net.swapped == 0
    x = torch.from_numpy(_x(1, 3, 32, 32))
    with torch.inference_mode():
        want = m(x).numpy()
    np.testing.assert_array_equal(net.predict(x.numpy()), want)


def test_load_torch_file(tmp_path):
    m = _seeded(CASES["mlp"][0])
    p = str(tmp_path / "m.pt")
    torch.save(m, p)
    x = _x(3, 6)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        Net.load_torch_file(p, device="cpu").predict(x), want)
    torch.save(m.state_dict(), p)
    with pytest.raises(ValueError, match="not a torch module"):
        Net.load_torch_file(p, device="cpu")


def test_needs_a_device_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchNet(nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        Net.load_torch(nn.Linear(2, 2))


# ------------------------------------------------ A13: JAX's checkpoints

class LSTMSeq(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(5, 7, num_layers=2, batch_first=True)

    def forward(self, x):
        out, _ = self.lstm(x)
        return out


SNAPSHOT = {"conv_bn": (ConvBN, (16, 3, 8, 8), (16, 2)),
            "lstm": (LSTMSeq, (16, 4, 5), (16, 4, 7)),
            "mha": (lambda: AttnUser(True), (16, 6, 16), (16, 6, 3))}


def _data(name):
    _, xs, ys = SNAPSHOT[name]
    return _x(*xs), _x(*ys, seed=2)


def _jax_est(jt, module):
    return jt["Estimator"].from_torch(model=module, loss="mse",
                                      optimizer=jt["Adam"](1e-2),
                                      sample_input=np.zeros((2, 1)))


def _port_est(module):
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    return Estimator.from_torch(model=module, loss="mse",
                                optimizer=Adam(1e-2), device="cpu")


@pytest.mark.parametrize("name", sorted(SNAPSHOT))
def test_jax_snapshot_restores_in_the_port(jt, tmp_path, name):
    make = SNAPSHOT[name][0]
    x, y = _data(name)
    j = _jax_est(jt, _seeded(make, 3))
    j.fit((x, y), epochs=2, batch_size=8)
    j.save(str(tmp_path / "j"))
    from analytics_zoo_tpu_torch.learn import checkpoint as ckpt
    want, _ = ckpt.read_checkpoint(
        ckpt.find_latest_checkpoint(str(tmp_path / "j"))[0])
    t = _port_est(_seeded(make, 7).train())
    assert t._param_layout().kind == "torch_tree"
    t.load(str(tmp_path / "j"))
    tree = convert.torch_to_jax_tree(t.model)
    got_state = t._state_tree()
    for part, got in (("params", tree["params"]),
                      ("model_state", tree["buffers"]),
                      ("opt_state", got_state["opt_state"])):
        g, w = dict(_leaves(got)), dict(_leaves(want[part]))
        assert sorted(g) == sorted(w), part
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=part + k)
    assert int(got_state["step"]) == int(want["step"])
    im = InferenceModel(device="cpu").load_torch(_seeded(make, 9), x[:2])
    im.load_checkpoint(str(tmp_path / "j"))
    np.testing.assert_allclose(
        im.predict(x), TorchNet(t.model, device="cpu").predict(x),
        rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(SNAPSHOT))
def test_port_snapshot_restores_in_jax(jt, tmp_path, name):
    make = SNAPSHOT[name][0]
    x, y = _data(name)
    t = _port_est(_seeded(make, 3).train())
    t.fit((x, y), epochs=2, batch_size=8)
    t.save(str(tmp_path / "t"))
    want = convert.torch_to_jax_tree(t.model)
    j = _jax_est(jt, _seeded(make, 7))
    j.load(str(tmp_path / "t"))
    got = jt["jax"].device_get(j._state)
    for part, key in (("params", "params"), ("buffers", "model_state")):
        g = dict(_leaves(got[key]))
        w = dict(_leaves(want[part]))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert int(got["step"]) == t._py_step


def test_the_tree_plan_names_what_jax_names(jt):
    """Every case's plan round-trips: the tree back to a state dict is
    the module's own, and ``flax_paths`` reads JAX's paths."""
    for name, (make, _) in sorted(CASES.items()):
        m = _seeded(make)
        tree = convert.torch_to_jax_tree(m)
        sd = convert.jax_tree_to_state_dict(m, tree)
        own = m.state_dict()
        for k, v in sd.items():
            assert torch.equal(v, own[k]), (name, k)
        paths = {p for p, _, _ in convert.flax_paths(m).values()}
        assert paths == {k.lstrip("/") for k, _ in _leaves(tree["params"])}
    # a module JAX cannot translate keeps its torch names
    assert convert.ParamLayout(nn.Sequential(nn.Conv3d(1, 2, 1))).kind \
        == "torch"
    assert convert.torch_tree_plan(nn.LSTM(3, 4, bidirectional=True)) \
        is None
