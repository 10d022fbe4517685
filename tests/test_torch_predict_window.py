"""C24: ``TorchEstimator.predict(pipeline_window=)`` against the JAX
estimator's, on the CPU.

Mirrors JAX's ``tests/test_pipeline_io.py::
test_estimator_predict_pipelined_matches_sync``: windows 1, 2 and 4 give
the same bits (window 1 is the synchronous cadence: each batch read back
before the next launches), and each is within 1e-5 of JAX's
``predict(..., pipeline_window=w)`` of the same two-layer MLP from the
same parameters (flax ``Dense`` kernels transposed into ``nn.Linear``).
70 rows at batch 16 leave a padded, masked last batch. Also: XShards in,
``{"prediction": ...}`` shards out; a model with two outputs; the
window's spans under ``estimator_predict/batch-<n>`` in the tracer.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.data import HostXShards
from analytics_zoo_tpu_torch.learn import Estimator

WINDOWS = (1, 2, 4)


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l0 = torch.nn.Linear(4, 16)
        self.l1 = torch.nn.Linear(16, 1)

    def forward(self, x):
        return self.l1(torch.relu(self.l0(x)))


class _TwoHeads(_MLP):
    def forward(self, x):
        h = torch.relu(self.l0(x))
        return self.l1(h), h.sum(-1)


def _x(n=70, seed=2):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_pair():
    """JAX's estimator over a flax MLP and the port's over the same
    weights."""
    pytest.importorskip("jax")
    import flax.linen as nn
    import jax

    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            return nn.Dense(1)(nn.relu(nn.Dense(16)(x)))

    x = _x()
    jest = JEstimator.from_flax(model=MLP(), loss="mse",
                                optimizer=JAdam(1e-2), sample_input=x[:2])
    jest._init_state()
    params = jax.device_get(jest._state["params"])
    params = params.get("params", params)
    model = _MLP()
    # flax names the Dense layers in construction order (the outer one
    # first): match them to the torch layers by shape
    by_shape = {np.asarray(p["kernel"]).shape: p for p in params.values()}
    with torch.no_grad():
        for lin in (model.l0, model.l1):
            p = by_shape[(lin.in_features, lin.out_features)]
            lin.weight.copy_(torch.from_numpy(
                np.asarray(p["kernel"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    est = Estimator.from_torch(model=model, loss="mse", optimizer="adam",
                               device="cpu")
    return jest, est


def test_windows_are_bitwise_and_match_jax(jax_pair):
    jest, est = jax_pair
    x = _x()
    outs = {w: est.predict(x, batch_size=16, pipeline_window=w)
            for w in WINDOWS}
    assert outs[1].shape == (70, 1)
    for w in WINDOWS[1:]:
        np.testing.assert_array_equal(outs[w], outs[1])
    for w in WINDOWS:
        want = np.asarray(jest.predict(x, batch_size=16, pipeline_window=w))
        np.testing.assert_allclose(outs[w], want, rtol=0, atol=1e-5)
    # the default window is 2, as JAX's
    np.testing.assert_array_equal(est.predict(x, batch_size=16), outs[1])


def test_windows_on_shards_and_several_outputs():
    torch.manual_seed(0)
    est = Estimator.from_torch(model=_TwoHeads(), loss="mse", device="cpu")
    x = _x(45, seed=3)
    outs = [est.predict(x, batch_size=8, pipeline_window=w)
            for w in WINDOWS]
    assert isinstance(outs[0], tuple) and outs[0][0].shape == (45, 1)
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)
    shards = HostXShards([{"x": x[:20]}, {"x": x[20:]}])
    for w in WINDOWS:
        got = est.predict(shards, batch_size=8, pipeline_window=w)
        assert isinstance(got, HostXShards)
        pred = got.collect()[0]["prediction"]
        for a, b in zip(pred, outs[0]):
            np.testing.assert_array_equal(a, b)


def test_window_records_its_spans():
    torch.manual_seed(1)
    est = Estimator.from_torch(model=_MLP(), loss="mse", device="cpu")
    before = telemetry.get_tracer().sampling
    telemetry.set_trace_sampling(1.0)
    try:
        est.predict(_x(32), batch_size=16, pipeline_window=2)
        spans = {s.name for s in telemetry.get_tracer().get(
            "estimator_predict/batch-1")}
    finally:
        telemetry.set_trace_sampling(before)
    assert {"inflight", "dispatch", "fetch"} <= spans
