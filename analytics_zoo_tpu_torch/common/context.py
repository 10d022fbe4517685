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
  without that argument ``init_orca_context`` raises. The reference's
  other mode names warn and run locally, and the Spark/Ray resource
  kwargs warn and are ignored, as in JAX.
- **Across ranks** (JAX ``common/context.py``'s ``jax.distributed``
  bootstrap). ``cluster_mode="multihost"`` or ``"tpu_pod"`` makes a
  ``torch.distributed`` process group, one rank a process and one device
  a rank (ROADMAP C27): ``init_process_group(init_method=
  f"tcp://{coordinator_address}", world_size=num_processes,
  rank=process_id)``; without a coordinator, torchrun's environment
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``), and without that ``ValueError``, as JAX raises where
  it cannot find its coordinator. The backend is NCCL with the rank on
  ``cuda:<LOCAL_RANK>`` (else ``cuda:<process_id>``); more ranks on a host
  than cards raises naming both counts (NCCL refuses two ranks on one
  card). ``device="cpu"`` makes a gloo group on the host. A process
  group the caller made already (``parallel/launch.py``, a launcher of
  its own, several ranks sharing a card over gloo) is adopted as it is,
  never re-made on another backend; ``stop_orca_context`` destroys a
  group the context made and leaves an adopted one alone. The default
  mesh then spans the ranks (``parallel/mesh.py``).
- **Reproducible convolutions** (ROADMAP C20). ``init_orca_context`` sets
  ``torch.backends.cudnn.deterministic = True`` and ``benchmark =
  False``: cuDNN then picks deterministic algorithms, and a fit repeats
  bit for bit, as JAX's does on a TPU. A caller who wants cuDNN's
  nondeterministic algorithms sets the flags after ``init_orca_context``;
  ``stop_orca_context`` puts back what they were.
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
        #: True where init_orca_context made the process group
        self.owns_group = False

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
    """``default_matmul_precision``'s flags, and cuDNN's deterministic
    algorithms (C20)."""
    global _saved_precision
    cudnn = torch.backends.cudnn
    if _saved_precision is None:
        _saved_precision = (torch.get_float32_matmul_precision(),
                            cudnn.allow_tf32, cudnn.deterministic,
                            cudnn.benchmark)
    matmul, cudnn_tf32 = PRECISION[name]
    torch.set_float32_matmul_precision(matmul)
    cudnn.allow_tf32 = cudnn_tf32
    cudnn.deterministic = True
    cudnn.benchmark = False


def _restore_precision() -> None:
    global _saved_precision
    if _saved_precision is not None:
        cudnn = torch.backends.cudnn
        torch.set_float32_matmul_precision(_saved_precision[0])
        (cudnn.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = _saved_precision[1:]
        _saved_precision = None


def _rank_env(coordinator_address, num_processes, process_id):
    """``(init_method, world size, rank, local rank)`` from the arguments,
    else from torchrun's environment; ValueError without either."""
    import os
    env = os.environ
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("cluster_mode='multihost' with a "
                             "coordinator_address needs num_processes and "
                             "process_id")
        local = int(env.get("LOCAL_RANK", process_id))
        return (f"tcp://{coordinator_address}", int(num_processes),
                int(process_id), local)
    if all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                              "WORLD_SIZE")):
        world = int(env["WORLD_SIZE"] if num_processes is None
                    else num_processes)
        rank = int(env["RANK"] if process_id is None else process_id)
        return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", world,
                rank, int(env.get("LOCAL_RANK", rank)))
    raise ValueError(
        "cluster_mode='multihost': no coordinator: pass "
        "coordinator_address='host0:port', num_processes and process_id, "
        "or run under torchrun (MASTER_ADDR, MASTER_PORT, RANK, "
        "WORLD_SIZE)")


def _join_ranks(coordinator_address, num_processes, process_id, device):
    """Make the process group (or adopt the caller's); ``(this rank's
    device, whether the context made the group, world size, rank)``."""
    import torch.distributed as dist
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if device is not None:
            return torch.device(device), False, world, rank
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_orca_context: CUDA is not available; pass "
                "device='cpu' to join the process group on the host")
        return torch.device("cuda", torch.cuda.current_device()), False, \
            world, rank
    init_method, world, rank, local = _rank_env(
        coordinator_address, num_processes, process_id)
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank)
        return torch.device("cpu"), True, world, rank
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_orca_context: CUDA is not available; pass device='cpu' "
            "for a gloo group on the host")
    cards = torch.cuda.device_count()
    if local >= cards:
        raise ValueError(
            f"local rank {local} on a host with {cards} card(s): NCCL "
            "runs one rank a card; start at most one rank a card, or make "
            "the process group yourself (gloo) and init_orca_context "
            "adopts it")
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init_method,
                            world_size=world, rank=rank)
    return dev, True, world, rank


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
        cluster_mode: "local" (default); "multihost" / "tpu_pod" join the
            ranks (the module docstring); other reference mode names warn
            and run locally.
        mesh_axes / mesh_shape: the default mesh's layout, a 1-D
            ``("data",)`` mesh over the devices (the ranks, across
            ranks) by default.
        coordinator_address, num_processes, process_id: the process
            group's address (``host:port``), world size and this rank.
        device: None or "cuda" for every CUDA device, else one device
            ("cpu", "cuda:1"); across ranks, this rank's device ("cpu"
            makes a gloo group).
    """
    global _active_context
    if _active_context is not None:
        warnings.warn("init_orca_context called twice; returning existing "
                      "context")
        return _active_context

    legacy = sorted(k for k in kwargs if k in LEGACY_KWARGS)
    if legacy:
        warnings.warn(f"Spark/Ray-era kwargs ignored: {legacy}")

    from analytics_zoo_tpu_torch.parallel.mesh import build_mesh
    if cluster_mode in ("multihost", "tpu_pod"):
        own, made, world, rank = _join_ranks(
            coordinator_address, num_processes, process_id, device)
        devices = [own]
        # the mesh reads the context's device: set it first
        with _context_lock:
            _active_context = ZooTpuContext(
                cluster_mode, None, devices, num_processes=world,
                process_index=rank)
            _active_context.owns_group = made
        try:
            _active_context.mesh = build_mesh(axes=mesh_axes,
                                              shape=mesh_shape)
        except Exception:
            stop_orca_context()
            raise
        _apply_precision(OrcaContext.default_matmul_precision)
        atexit.register(stop_orca_context)
        logger.info("Initialized %r", _active_context)
        return _active_context
    if cluster_mode != "local":
        warnings.warn(f"cluster_mode={cluster_mode!r} has no analog here; "
                      "running in local mode")
        cluster_mode = "local"

    devices = _context_devices(device)
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
        made = getattr(_active_context, "owns_group", False)
        _mesh_mod.set_default_mesh(None)
        _active_context = None
    if made:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    _restore_precision()
