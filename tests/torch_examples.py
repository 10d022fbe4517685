"""Run the port's example scripts (``examples_torch/``) and their JAX
twins (``examples/``) as subprocesses, as ``tests/test_examples.py``
runs JAX's: the port's with ``--device cpu``, JAX's on the CPU platform.

A run can tap functions of the package it uses: each tap wraps one
attribute (``FeatureTable.to_pandas``, ``TextSet.get_word_index``, ...)
named by its module under the package (``friesian.feature.table``), so
the same tap reads the same function in either package, and the values
it returned are pickled for the test to compare. A stop ends a twin run
at the call after which nothing of it is compared (the model's fit),
so a parity test pays only for the host code it reads. Python's
``random`` is seeded with 0 before each script runs (the image
transforms draw from it), so both packages' draws are the same; JAX's
context gets one CPU device, as the port's has one. Several of the
port's scripts can run one after another in one process, each as it
would alone (its own working directory, a temporary one where the fits'
summaries land, its own output and exit status, the seeds reset and the
context stopped between scripts). This module imports neither package.
"""

import collections
import json
import os
import pickle
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "examples_torch")
JAX_DIR = os.path.join(REPO, "examples")

#: the four JAX marks slow (tests/test_examples.py), marked slow here too
SLOW = {"distributed_training.py", "autots_forecast.py",
        "object_detection.py", "multihost_launch.py"}

Run = collections.namedtuple("Run", "rc stdout stderr taps")

_LAUNCHER = r"""
import contextlib, importlib, io, json, os, pickle, random, runpy, sys
import traceback
spec = json.loads(sys.argv[1])
if spec["jax"]:
    import jax
    jax.config.update("jax_platforms", "cpu")

    def stop_context():
        pass
else:
    import torch
    from analytics_zoo_tpu_torch.common.context import (
        stop_orca_context as stop_context)
    # the seed a fresh process starts from: each script of the batch
    # draws from it as it would alone
    torch_seed = torch.initial_seed()
records = {}


class Stop(BaseException):
    pass


def tap(label, module, attr, stop=False):
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    own = name in vars(owner)
    orig = getattr(owner, name)

    def wrapped(*a, **k):
        if stop:
            raise Stop(f"{module}.{attr}")
        out = orig(*a, **k)
        records.setdefault(label, []).append(out)
        return out
    setattr(owner, name, wrapped)
    if own:
        return lambda: setattr(owner, name, orig)
    return lambda: delattr(owner, name)


results = []
for run in spec["runs"]:
    records = {}
    undo = [tap(*t) for t in run["taps"]] + [
        tap("stop", m, a, stop=True) for m, a in run["stop"]]
    random.seed(0)
    if not spec["jax"]:
        torch.manual_seed(torch_seed)
    os.chdir(run["cwd"])
    sys.argv = [run["script"]] + run["args"]
    out, err, rc = io.StringIO(), io.StringIO(), 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            runpy.run_path(run["script"], run_name="__main__")
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else int(
                e.code is not None)
        except Stop as e:
            print(f"stopped at {e}: the rest is not compared",
                  file=sys.stderr)
        except BaseException:
            traceback.print_exc()
            rc = 1
        finally:
            stop_context()
            for u in reversed(undo):
                u()
    results.append((rc, out.getvalue(), err.getvalue(), records))
with open(spec["out"], "wb") as fh:
    pickle.dump(results, fh)
"""


def _env():
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    # one device for JAX's context, as the port's has: the data pipelines
    # cut their default shards by it, and the image transforms of several
    # shards draw from Python's random in the pool's order
    env["XLA_FLAGS"] = " ".join(
        [f for f in env.get("XLA_FLAGS", "").split()
         if not f.startswith("--xla_force_host_platform_device_count")]
        + ["--xla_cpu_multi_thread_eigen=false",
           "intra_op_parallelism_threads=1"])
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    # one intra-op thread a process (torch's and XLA's), as the suite's
    # workers share the cores
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def run_batch(scripts, workdirs, jax=False, taps=None, stops=None,
              timeout=900):
    """Run ``scripts`` (the port's, or with ``jax=True`` JAX's twins) one
    after another in ONE process, each in its own ``workdirs[i]``, with
    Python's ``random`` and torch's default generator seeded before each
    as in a fresh process; ``taps`` maps a script to its ``(label, module
    under the package, attribute)`` taps, ``stops`` to the ``(module,
    attribute)`` whose call ends the script there (its exit status 0: a
    twin run only for what comes before). Returns a ``Run`` a script."""
    pkg = "analytics_zoo_tpu" if jax else "analytics_zoo_tpu_torch"
    runs = []
    for script, workdir in zip(scripts, workdirs):
        os.makedirs(str(workdir), exist_ok=True)
        runs.append({
            "script": os.path.join(JAX_DIR if jax else PORT_DIR, script),
            "args": [] if jax else ["--device", "cpu"],
            "cwd": str(workdir),
            "taps": [(label, f"{pkg}.{mod}", attr)
                     for label, mod, attr in (taps or {}).get(script, ())],
            "stop": [(f"{pkg}.{mod}", attr)
                     for mod, attr in (stops or {}).get(script, ())]})
    out = os.path.join(str(workdirs[0]), "runs.pkl")
    spec = {"jax": jax, "runs": runs, "out": out}
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCHER, json.dumps(spec)],
        cwd=str(workdirs[0]), capture_output=True, text=True,
        timeout=timeout, env=_env())
    if not os.path.exists(out):
        # the process itself failed: every script of it did
        return [Run(proc.returncode or 1, proc.stdout, proc.stderr, {})
                for _ in scripts]
    with open(out, "rb") as fh:
        results = pickle.load(fh)
    return [Run(rc, o, e + (proc.stderr if i == len(results) - 1 else ""),
                t) for i, (rc, o, e, t) in enumerate(results)]


def run(script, workdir, jax=False, taps=(), timeout=900):
    """Run ``script`` alone in a process of its own (``run_batch``);
    ``taps`` are ``(label, module under the package, attribute)``."""
    return run_batch([script], [workdir], jax=jax, taps={script: taps},
                     timeout=timeout)[0]


def runner(tmp_path_factory, jax=False, taps=None, batch=(), stops=None):
    """``get(script)``: the script's ``Run``, made once (a module-scoped
    fixture's cache). The scripts of ``batch`` run together in one
    process at the first ``get`` of any of them, which spares each its
    own interpreter and imports; any other runs alone. ``taps`` and
    ``stops`` map a script to its taps and stops (``run_batch``)."""
    cache = {}

    def workdir(script):
        return tmp_path_factory.mktemp(script[:-3] + ("_jax" if jax else ""))

    def get(script):
        if script not in cache:
            group = list(batch) if script in batch else [script]
            for name, res in zip(group, run_batch(
                    group, [workdir(s) for s in group], jax=jax, taps=taps,
                    stops=stops)):
                cache[name] = res
        return cache[script]
    return get


def check(res: Run, script: str, *lines):
    """The run exited 0 (its own asserts held) and printed each of
    ``lines`` as the start of a line of its output."""
    assert res.rc == 0, (f"{script} failed:\nstdout:\n{res.stdout[-3000:]}"
                         f"\nstderr:\n{res.stderr[-3000:]}")
    out = res.stdout.splitlines()
    for want in lines:
        assert any(line.startswith(want) for line in out), (want, out)


def lines_starting(res: Run, prefix: str):
    return [line for line in res.stdout.splitlines()
            if line.startswith(prefix)]


def raises_without_cuda(script, monkeypatch):
    """The script run with no arguments where CUDA is absent: it raises
    RuntimeError naming ``device='cpu'`` (no CPU fallback)."""
    import runpy
    import pytest
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [script])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runpy.run_path(os.path.join(PORT_DIR, script), run_name="__main__")


def assert_same(got, want, where="value"):
    """Deep equality of tapped values: dicts, lists and tuples entry by
    entry, numpy arrays bitwise (dtype and shape too), others by ``==``."""
    import numpy as np
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (where, type(got), len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)
