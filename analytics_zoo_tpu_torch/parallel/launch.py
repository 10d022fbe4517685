"""Run a function on N local ranks, each a process of its own.

The port's counterpart of ``examples/multihost_launch.py``'s launcher
mode. ``launch(fn, nprocs, args=..., device=..., backend=...)`` starts
``nprocs`` Python processes, each of which makes a ``torch.distributed``
process group over a free TCP port on this host (``tcp://127.0.0.1:<port>``,
a port bound afresh for each launch), calls ``fn(*args)`` and
writes its JSON-able result; ``launch`` returns the results in rank
order. A rank that exits non-zero fails the launch: the other ranks are
stopped and the error names the rank and shows its stderr.

- ``fn``: a module-level function, or ``"module:function"``, or
  ``"path/to/file.py:function"`` (a function of a script run as
  ``__main__`` is found by its file).
- ``device="cpu"``: the ranks run on the host, with one intra-op thread
  each (``torch.set_num_threads(1)``), over gloo by default.
  ``device="cuda"``: rank ``r`` on ``cuda:<r>`` over NCCL by default (one
  card a rank, as NCCL needs). ``device="cuda:0"`` with
  ``backend="gloo"`` puts every rank on that one card over gloo, which
  is how several ranks rehearse on one card.
- Each rank's environment has torchrun's names (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), so
  ``init_orca_context(cluster_mode="multihost")`` inside ``fn`` adopts
  the group the launcher made.

Run a rank by hand: ``python -m analytics_zoo_tpu_torch.parallel.launch
--target module:function --spec spec.json --out result.json`` with the
environment above.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Union

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port of this host that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _target(fn: Union[str, Callable]) -> str:
    if isinstance(fn, str):
        return fn
    mod = fn.__module__
    if mod == "__main__":
        mod = os.path.abspath(sys.modules["__main__"].__file__)
    return f"{mod}:{fn.__qualname__}"


def _resolve(target: str) -> Callable:
    mod, _, name = target.rpartition(":")
    if mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_zoo_launch_target",
                                                      mod)
        module = importlib.util.module_from_spec(spec)
        sys.modules["_zoo_launch_target"] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod)
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def launch(fn: Union[str, Callable], nprocs: int, args: Sequence = (),
           device: str = "cpu", backend: Optional[str] = None,
           timeout: float = 600.0, group: bool = True) -> List[Any]:
    """``fn(*args)`` on ``nprocs`` ranks; each rank's return value
    (JSON-able), in rank order. ``args`` must be JSON-able.
    ``group=False``: the ranks make no process group (``fn`` makes its
    own, e.g. through ``init_orca_context``). Raises
    ``RuntimeError`` with the failing rank's stderr if any rank exits
    non-zero, and ``TimeoutError`` past ``timeout`` seconds."""
    nprocs = int(nprocs)
    if backend is None:
        backend = "gloo" if device == "cpu" else "nccl"
    port = free_port()
    work = tempfile.mkdtemp(prefix="zoo_launch_")
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump({"args": list(args), "device": device, "backend": backend,
                   "group": bool(group)}, fh)
    procs, files = [], []
    path = os.pathsep.join([_REPO, os.getcwd()] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    try:
        for rank in range(nprocs):
            renv = dict(os.environ)
            renv.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                        LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), PYTHONPATH=path)
            out = os.path.join(work, f"rank{rank}.json")
            err = open(os.path.join(work, f"rank{rank}.err"), "w+")
            log = open(os.path.join(work, f"rank{rank}.out"), "w+")
            files.append((out, err, log))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "analytics_zoo_tpu_torch.parallel."
                 "launch", "--target", _target(fn), "--spec", spec_path,
                 "--out", out], env=renv, stdout=log, stderr=err,
                cwd=os.getcwd()))
        deadline = time.monotonic() + timeout
        pending = set(range(nprocs))
        while pending:
            for rank in sorted(pending):
                rc = procs[rank].poll()
                if rc is None:
                    continue
                pending.discard(rank)
                if rc != 0:
                    err = files[rank][1]
                    err.flush()
                    err.seek(0)
                    tail = err.read()[-6000:]
                    raise RuntimeError(
                        f"rank {rank} of {nprocs} exited with {rc}; its "
                        f"stderr:\n{tail}")
            if pending and time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(pending)} of {nprocs} "
                                   f"still running after {timeout} s")
            time.sleep(0.05)
        results = []
        for out, _, _ in files:
            with open(out) as fh:
                results.append(json.load(fh))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for _, err, log in files:
            err.close()
            log.close()
        import shutil
        shutil.rmtree(work, ignore_errors=True)


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    with open(a.spec) as fh:
        spec = json.load(fh)
    import torch
    import torch.distributed as dist
    device = spec["device"]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device == "cpu":
        torch.set_num_threads(1)
    elif device == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    else:
        torch.cuda.set_device(torch.device(device))
    if spec["group"]:
        dist.init_process_group(
            backend=spec["backend"], world_size=world, rank=rank,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                        f"{os.environ['MASTER_PORT']}")
    try:
        result = _resolve(a.target)(*spec["args"])
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(a.out + ".tmp", "w") as fh:
        json.dump(result, fh)
    os.replace(a.out + ".tmp", a.out)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
