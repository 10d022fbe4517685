"""Context bootstrap and global configuration.

Counterpart of ``analytics_zoo_tpu/common/context.py`` (ref
``pyzoo/zoo/orca/common.py:21-255``):

- ``OrcaContext`` — the config singleton, every knob of JAX's
  ``OrcaContextMeta`` with its name, default and accepted values:
  ``pandas_read_backend`` ("pandas" | "arrow"), ``serialize_data_creator``
  (bool), ``train_data_store`` ("DRAM" | "DISK_n" | "NATIVE_n", see
  below), ``shard_size`` (None or an int above 0),
  ``default_matmul_precision`` ("bfloat16" | "tensorfloat32" | "float32")
  and ``checkpoint_max_to_keep`` (an int above 0). Where JAX asserts, the
  port raises ``ValueError``.
- ``init_orca_context`` / ``stop_orca_context`` and ``ZooTpuContext``
  (the name kept): the devices of this process and the default mesh
  (``parallel/mesh.py``). The devices are every CUDA device unless the
  caller passes ``device="cpu"`` (or one device); without CUDA and
  without that argument ``init_orca_context`` raises. One process drives
  them: ``cluster_mode="multihost"`` / ``"tpu_pod"`` raise
  (``torch.distributed`` across hosts is ROADMAP A9); the reference's
  other mode names warn and run locally, and the Spark/Ray resource
  kwargs warn and are ignored, as in JAX.
- **Precision.** JAX applies ``default_matmul_precision`` through
  ``jax_default_matmul_precision``; on a GPU its "bfloat16" and
  "tensorfloat32" mean TF32 and "float32" full fp32. The port maps
  "bfloat16" and "tensorfloat32" to
  ``torch.set_float32_matmul_precision("high")`` with
  ``torch.backends.cudnn.allow_tf32 = True``, and "float32" to "highest"
  with ``cudnn.allow_tf32 = False`` (ROADMAP C13). ``stop_orca_context``
  puts back the flags ``init_orca_context`` changed.
- ``train_data_store="NATIVE_n"`` is the C++ arena
  (``data/native_store.py``), built by g++ at a store's first use; where
  g++ is missing or fails, the store raises ``NativeStoreCompileError``: it
  never quietly becomes ``DISK_n`` as JAX's falls back (ROADMAP C26).
"""

from __future__ import annotations

import atexit
import logging
import threading
import warnings
from typing import List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)

_active_context: Optional["ZooTpuContext"] = None
# guards the init/stop transitions of _active_context
_context_lock = threading.Lock()
# (float32 matmul precision, cudnn.allow_tf32) before init changed them
_saved_precision = None

#: the Spark/Ray-era kwargs init_orca_context accepts and ignores
LEGACY_KWARGS = ("cores", "memory", "num_nodes", "init_ray_on_spark",
                 "conda_name", "extra_python_lib", "penv_archive")

#: default_matmul_precision -> (torch float32 matmul precision, cudnn TF32)
PRECISION = {"bfloat16": ("high", True), "tensorfloat32": ("high", True),
             "float32": ("highest", False)}


def check_tier(tier: str) -> str:
    """``tier`` upper-cased if the port has a store for it: "DRAM",
    "DISK_n" (spill files) or "NATIVE_n" (the native arena,
    ``data/native_store.py``, built by g++ at its first use)."""
    tier = tier.upper()
    if tier != "DRAM" and not tier.startswith(("DISK_", "NATIVE_")):
        raise ValueError("train_data_store must be 'DRAM', 'DISK_n' or "
                         f"'NATIVE_n', got {tier!r}")
    return tier


def _positive_int(name: str, value) -> None:
    if not isinstance(value, int) or isinstance(value, bool) or value <= 0:
        raise ValueError(f"{name} must be an int above 0, got {value!r}")


class OrcaContextMeta(type):
    """Class-property-style global knobs (ref pyzoo/zoo/orca/common.py:
    21-122)."""

    _eager_mode = True
    _pandas_read_backend = "pandas"
    _serialize_data_creator = False
    _train_data_store = "DRAM"
    _shard_size = None
    _default_matmul_precision = "bfloat16"
    _checkpoint_max_to_keep = 5

    @property
    def pandas_read_backend(cls) -> str:
        """'pandas' or 'arrow' (the reference's 'spark' is JVM-only)."""
        return cls._pandas_read_backend

    @pandas_read_backend.setter
    def pandas_read_backend(cls, value: str):
        value = value.lower()
        if value not in ("pandas", "arrow"):
            raise ValueError("pandas_read_backend must be 'pandas' or "
                             f"'arrow', got {value!r}")
        cls._pandas_read_backend = value

    @property
    def serialize_data_creator(cls) -> bool:
        return cls._serialize_data_creator

    @serialize_data_creator.setter
    def serialize_data_creator(cls, value: bool):
        if not isinstance(value, bool):
            raise ValueError(f"serialize_data_creator must be a bool, got "
                             f"{value!r}")
        cls._serialize_data_creator = value

    @property
    def train_data_store(cls) -> str:
        """Shard store tier: "DRAM" keeps every shard live; "DISK_n" spills
        every shard to a pickle and keeps 1 of every n resident (ref
        FeatureSet.scala:556 DISK_n)."""
        return cls._train_data_store

    @train_data_store.setter
    def train_data_store(cls, value: str):
        cls._train_data_store = check_tier(value)

    @property
    def shard_size(cls) -> Optional[int]:
        """Target rows per shard for the XShards readers (ref
        common.py:96-110)."""
        return cls._shard_size

    @shard_size.setter
    def shard_size(cls, value: Optional[int]):
        if value is not None:
            _positive_int("shard_size", value)
        cls._shard_size = value

    @property
    def default_matmul_precision(cls) -> str:
        """'bfloat16' | 'tensorfloat32' | 'float32', applied by
        ``init_orca_context`` (the module docstring has the mapping)."""
        return cls._default_matmul_precision

    @default_matmul_precision.setter
    def default_matmul_precision(cls, value: str):
        if value not in PRECISION:
            raise ValueError(f"default_matmul_precision must be one of "
                             f"{sorted(PRECISION)}, got {value!r}")
        cls._default_matmul_precision = value

    @property
    def checkpoint_max_to_keep(cls) -> int:
        """How many versions ``learn/checkpoint.save_checkpoint`` keeps in
        a directory."""
        return cls._checkpoint_max_to_keep

    @checkpoint_max_to_keep.setter
    def checkpoint_max_to_keep(cls, value: int):
        _positive_int("checkpoint_max_to_keep", value)
        cls._checkpoint_max_to_keep = value


class OrcaContext(metaclass=OrcaContextMeta):
    """Global configuration singleton (ref pyzoo/zoo/orca/common.py:21)."""

    @staticmethod
    def get_context() -> "ZooTpuContext":
        if _active_context is None:
            raise RuntimeError(
                "No active context. Call init_orca_context() first.")
        return _active_context

    @staticmethod
    def get_mesh():
        return OrcaContext.get_context().mesh


def active_context() -> Optional["ZooTpuContext"]:
    """The context ``init_orca_context`` made, or None."""
    return _active_context


class ZooTpuContext:
    """The devices of this process and the default mesh (the name is the
    JAX package's; ref pyzoo/zoo/orca/common.py:126-146)."""

    def __init__(self, cluster_mode: str, mesh, devices: List[torch.device],
                 num_processes: int = 1, process_index: int = 0):
        self.cluster_mode = cluster_mode
        self.mesh = mesh
        self._devices = list(devices)
        self.num_processes = num_processes
        self.process_index = process_index

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    @property
    def local_devices(self) -> List[torch.device]:
        return list(self._devices)

    @property
    def num_devices(self) -> int:
        return len(self._devices)

    def __repr__(self):
        return (f"ZooTpuContext(mode={self.cluster_mode!r}, "
                f"devices={self.num_devices}, mesh={self.mesh})")


def _context_devices(device) -> List[torch.device]:
    """Every CUDA device for None or "cuda", else the one device named;
    CUDA asked for without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_orca_context: CUDA is not available; pass "
                "device='cpu' to run on the host")
        if dev.index is None:
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    return [dev]


def _apply_precision(name: str) -> None:
    global _saved_precision
    if _saved_precision is None:
        _saved_precision = (torch.get_float32_matmul_precision(),
                            torch.backends.cudnn.allow_tf32)
    matmul, cudnn_tf32 = PRECISION[name]
    torch.set_float32_matmul_precision(matmul)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _restore_precision() -> None:
    global _saved_precision
    if _saved_precision is not None:
        torch.set_float32_matmul_precision(_saved_precision[0])
        torch.backends.cudnn.allow_tf32 = _saved_precision[1]
        _saved_precision = None


def init_orca_context(cluster_mode: str = "local",
                      mesh_axes: Optional[Sequence[str]] = None,
                      mesh_shape: Optional[Sequence[int]] = None,
                      coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      device=None, **kwargs) -> ZooTpuContext:
    """Find this process's devices, apply ``default_matmul_precision`` and
    build the default mesh (ref ``init_orca_context(cluster_mode, cores,
    memory, ...)``, pyzoo/zoo/orca/common.py:148).

    Args:
        cluster_mode: "local" (default); "multihost" / "tpu_pod" raise
            (ROADMAP A9); other reference mode names warn and run locally.
        mesh_axes / mesh_shape: the default mesh's layout, a 1-D
            ``("data",)`` mesh over the devices by default.
        coordinator_address, num_processes, process_id: JAX's multi-host
            bootstrap; accepted for the signature, used by no mode here.
        device: None or "cuda" for every CUDA device, else one device
            ("cpu", "cuda:1").
    """
    global _active_context
    if _active_context is not None:
        warnings.warn("init_orca_context called twice; returning existing "
                      "context")
        return _active_context

    legacy = sorted(k for k in kwargs if k in LEGACY_KWARGS)
    if legacy:
        warnings.warn(f"Spark/Ray-era kwargs ignored: {legacy}")

    if cluster_mode in ("multihost", "tpu_pod"):
        raise NotImplementedError(
            f"cluster_mode={cluster_mode!r}: the port drives the devices "
            "of one process; torch.distributed across hosts is ROADMAP A9")
    if cluster_mode != "local":
        warnings.warn(f"cluster_mode={cluster_mode!r} has no analog here; "
                      "running in local mode")
        cluster_mode = "local"

    devices = _context_devices(device)
    from analytics_zoo_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(axes=mesh_axes, shape=mesh_shape, devices=devices)
    _apply_precision(OrcaContext.default_matmul_precision)
    with _context_lock:
        _active_context = ZooTpuContext(cluster_mode, mesh, devices)
    atexit.register(stop_orca_context)
    logger.info("Initialized %r", _active_context)
    return _active_context


def stop_orca_context() -> None:
    """Drop the context and the default mesh, and put back the precision
    flags (ref pyzoo/zoo/orca/common.py:242-255)."""
    global _active_context
    if _active_context is None:
        return
    from analytics_zoo_tpu_torch.parallel import mesh as _mesh_mod
    with _context_lock:
        _mesh_mod.set_default_mesh(None)
        _active_context = None
    _restore_precision()
