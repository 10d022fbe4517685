"""The port's context layer (``common/context.py``, ``parallel/mesh.py``)
against the JAX package's, on the CPU.

- Every ``OrcaContext`` knob has JAX's default and accepts and refuses
  the same values (the port raises ValueError where JAX asserts);
  ``train_data_store="NATIVE_n"`` is accepted, and a shard store of that
  tier whose library g++ cannot build raises ``NativeStoreCompileError``
  naming g++ (never the DISK_n fallback).
- ``init_orca_context``: the Spark/Ray kwargs warn, a second call warns
  and returns the live context, ``multihost`` / ``tpu_pod`` raise naming
  A9, no CUDA and no ``device="cpu"`` raises, the precision flags are set
  as ``default_matmul_precision`` says and put back by
  ``stop_orca_context``.
- ``build_mesh`` infers ``-1`` and refuses shapes as JAX's does over the
  same number of devices; the default shard count and the estimator's
  device come from the context.

JAX is imported by fixtures only.
"""

import re

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import (OrcaContext, init_orca_context,
                                     stop_orca_context)
from analytics_zoo_tpu_torch.common import context as ctx_mod
from analytics_zoo_tpu_torch.data import HostXShards, XShards
from analytics_zoo_tpu_torch.parallel import mesh as mesh_mod

KNOBS = {"pandas_read_backend": "pandas", "serialize_data_creator": False,
         "train_data_store": "DRAM", "shard_size": None,
         "default_matmul_precision": "bfloat16",
         "checkpoint_max_to_keep": 5}


@pytest.fixture(autouse=True)
def _clean_context():
    yield
    stop_orca_context()
    for k, v in KNOBS.items():
        setattr(OrcaContext, k, v)


@pytest.fixture(scope="module")
def jax_ctx():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.common import context
    return context


def test_knob_defaults_equal_jax(jax_ctx):
    for name, default in KNOBS.items():
        assert getattr(OrcaContext, name) == default
        assert getattr(jax_ctx.OrcaContext, name) == default, name


@pytest.mark.parametrize("name,good,bad", [
    ("pandas_read_backend", ["pandas", "ARROW"], ["spark"]),
    ("serialize_data_creator", [True, False], [1]),
    ("train_data_store", ["dram", "DISK_4"], ["PMEM", "SSD_2"]),
    ("shard_size", [None, 7], [0, -3, 2.5]),
    ("default_matmul_precision", ["bfloat16", "tensorfloat32", "float32"],
     ["highest", "fp16"]),
    ("checkpoint_max_to_keep", [1, 9], [0, "3"]),
])
def test_knob_accepts_and_refuses_as_jax(jax_ctx, name, good, bad):
    jax_default = getattr(jax_ctx.OrcaContext, name)
    try:
        for v in good:
            setattr(OrcaContext, name, v)
            setattr(jax_ctx.OrcaContext, name, v)
            assert getattr(OrcaContext, name) == \
                getattr(jax_ctx.OrcaContext, name)
        for v in bad:
            with pytest.raises(ValueError):
                setattr(OrcaContext, name, v)
            with pytest.raises(AssertionError):
                setattr(jax_ctx.OrcaContext, name, v)
    finally:
        setattr(jax_ctx.OrcaContext, name, jax_default)


def test_native_tier_raises_naming_its_item(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.data import native_store
    OrcaContext.train_data_store = "NATIVE_2"
    assert OrcaContext.train_data_store == "NATIVE_2"
    OrcaContext.train_data_store = "DRAM"
    # no library built and no g++ on the PATH: the store names g++
    monkeypatch.setattr(native_store, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_store, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(native_store.NativeStoreCompileError, match="g\\+\\+"):
        HostXShards([np.arange(4)], tier="native_4")


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_init_on_the_cpu_gives_one_device_and_a_data_mesh():
    ctx = init_orca_context(device="cpu")
    assert OrcaContext.get_context() is ctx
    assert ctx.devices == [torch.device("cpu")] == ctx.local_devices
    assert ctx.num_devices == 1 and ctx.cluster_mode == "local"
    assert OrcaContext.get_mesh() is ctx.mesh is mesh_mod.get_default_mesh()
    assert ctx.mesh.axis_names == ("data",)
    assert ctx.mesh.shape == {"data": 1}
    assert repr(ctx) == ("ZooTpuContext(mode='local', devices=1, "
                         "mesh=DeviceMesh('data': 1))")
    stop_orca_context()
    with pytest.raises(RuntimeError, match="init_orca_context"):
        OrcaContext.get_context()
    assert mesh_mod._default_mesh is None


def test_legacy_kwargs_warn_and_are_ignored():
    with pytest.warns(UserWarning, match=r"\['cores', 'memory'\]"):
        ctx = init_orca_context(device="cpu", cores=4, memory="2g")
    assert ctx.num_devices == 1


def test_second_init_warns_and_returns_the_live_context():
    first = init_orca_context(device="cpu")
    with pytest.warns(UserWarning, match="twice"):
        again = init_orca_context(device="cpu",
                                  mesh_axes=("data", "model"),
                                  mesh_shape=(1, 1))
    assert again is first and first.mesh.axis_names == ("data",)


def test_reference_mode_names_run_locally():
    with pytest.warns(UserWarning, match="local mode"):
        ctx = init_orca_context("yarn-client", device="cpu")
    assert ctx.cluster_mode == "local"


@pytest.mark.parametrize("mode", ["multihost", "tpu_pod"])
def test_multihost_raises(mode):
    with pytest.raises(NotImplementedError, match="A9"):
        init_orca_context(mode, device="cpu",
                          coordinator_address="localhost:1234")
    assert ctx_mod.active_context() is None


def test_no_cuda_and_no_cpu_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_orca_context(device=device)
        assert ctx_mod.active_context() is None


@pytest.mark.parametrize("precision,matmul,cudnn_tf32", [
    ("bfloat16", "high", True), ("tensorfloat32", "high", True),
    ("float32", "highest", False)])
def test_precision_flags_set_then_put_back(precision, matmul, cudnn_tf32):
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cudnn.allow_tf32)
    # start from the other setting, so each flag visibly changes
    torch.set_float32_matmul_precision(
        "highest" if matmul == "high" else "high")
    torch.backends.cudnn.allow_tf32 = not cudnn_tf32
    try:
        OrcaContext.default_matmul_precision = precision
        init_orca_context(device="cpu")
        assert torch.get_float32_matmul_precision() == matmul
        assert torch.backends.cudnn.allow_tf32 is cudnn_tf32
        assert torch.backends.cuda.matmul.allow_tf32 is (matmul == "high")
        stop_orca_context()
        assert torch.get_float32_matmul_precision() == \
            ("highest" if matmul == "high" else "high")
        assert torch.backends.cudnn.allow_tf32 is (not cudnn_tf32)
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


@pytest.mark.parametrize("axes,shape", [
    (None, None), (("data",), (-1,)), (("data", "model"), (-1, 2)),
    (("data", "model"), (2, -1)), (("data", "model"), (4, 2)),
    (("data", "model", "seq"), (2, -1, 2)),
    (("data", "model"), (3, -1)), (("data", "model"), (2, 2)),
    (("data", "model"), None)])
def test_build_mesh_matches_jax_over_eight_devices(axes, shape):
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.parallel import mesh as jax_mesh
    jdevs = jax.devices()
    assert len(jdevs) == 8
    devs = [torch.device("cpu")] * 8
    try:
        want = jax_mesh.build_mesh(axes, shape, devices=jdevs,
                                   set_default=False)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e)[:20])):
            mesh_mod.build_mesh(axes, shape, devices=devs,
                                set_default=False)
        return
    got = mesh_mod.build_mesh(axes, shape, devices=devs, set_default=False)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    for ax in ("data", "model", "seq", "pipe"):
        assert mesh_mod.mesh_axis_size(got, ax) == \
            jax_mesh.mesh_axis_size(want, ax)


def test_default_mesh_set_and_get():
    m = mesh_mod.build_mesh(devices=["cpu"], set_default=False)
    mesh_mod.set_default_mesh(m)
    assert mesh_mod.get_default_mesh() is m
    mesh_mod.set_default_mesh(None)
    init_orca_context(device="cpu")
    assert mesh_mod.get_default_mesh().shape == {"data": 1}


def test_default_shard_count_is_the_context_device_count():
    data = {"x": np.arange(24, dtype=np.float32).reshape(12, 2)}
    assert XShards.partition(data).num_partitions() == 1
    ctx = init_orca_context(device="cpu")
    ctx._devices = [torch.device("cpu")] * 4
    assert XShards.partition(data).num_partitions() == 4
    assert XShards.from_records(list(range(10))).num_partitions() == 4


def test_estimator_trains_on_the_context_device(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import Estimator, estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Estimator.from_torch(model=torch.nn.Linear(2, 1), loss="mse")
    init_orca_context(device="cpu")
    est = Estimator.from_torch(model=torch.nn.Linear(2, 1), loss="mse")
    assert est.device == torch.device("cpu")
    x = np.ones((8, 2), np.float32)
    hist = est.fit((x, np.zeros((8, 1), np.float32)), epochs=1,
                   batch_size=4)
    assert len(est.step_losses) == 2 and np.isfinite(hist["loss"]).all()
