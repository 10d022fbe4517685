"""Multi-host data-parallel training on the PyTorch port: a real
multi-process launch (the counterpart of examples/multihost_launch.py).

The reference's core deployment story is multi-node training launched by
``init_spark_on_yarn`` / ``init_spark_on_k8s`` (ref
pyzoo/zoo/common/nncontext.py:56,199) or by spawning MPI worker processes
(ref pyzoo/zoo/orca/learn/mpi/mpi_estimator.py:28). The port's analog:
every host runs the SAME program, one process a card;
``init_orca_context(cluster_mode="multihost", coordinator_address=...,
num_processes=..., process_id=...)`` makes the ``torch.distributed``
process group through the coordinator (NCCL between cards), and the
default mesh then spans every host's ranks.

    reference (Spark)                      this port
    -------------------------------------  ---------------------------------
    init_spark_on_yarn(num_executors=N)    one process per card on every
                                             host: python train.py, or
                                             torchrun (its environment is
                                             read when no coordinator is
                                             given)
    MPIEstimator(hosts=[...])              init_orca_context(
                                             cluster_mode="multihost",
                                             coordinator_address=host0:port,
                                             num_processes=N, process_id=i)

This script demonstrates the flow WITHOUT a cluster: launcher mode
(default) spawns ``--num-processes`` local worker processes of this same
file, so the whole cross-process path (the process group, the collectives,
per-process batch slicing) executes for real. On one card the workers
share it: each makes a gloo group itself (``--backend gloo``, as
``parallel/launch.py``'s ranks do) and the context adopts it; with
``--device cpu`` the context makes a gloo group on the host.

    python examples_torch/multihost_launch.py [--device cpu]   # launcher
    python examples_torch/multihost_launch.py --process-id 0 \
        --num-processes 2 --coordinator 127.0.0.1:9911        # one worker

Each worker feeds ONLY its own rows; per global step the processes
together consume one global batch (``batch_size`` is global: each process
feeds ``batch_size // process_count`` rows of it, the reference's per-core
batch slicing contract at pyzoo/zoo/tfpark/tf_dataset.py:117).
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import socket
import subprocess
import sys

def make_data(n=256, d=8, seed=7):
    """Deterministic synthetic regression problem (same on every host)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype("float32")
    w = rng.normal(size=(d, 1)).astype("float32")
    y = x @ w + 0.1 * rng.normal(size=(n, 1)).astype("float32")
    return x, y


def local_rows(n, global_batch, process_id, num_processes):
    """Row indices this process owns: for every global batch ``k`` process
    ``p`` holds rows ``[k*B + p*h, k*B + (p+1)*h)`` (h = B/num_processes) —
    so with shuffle=False the union of all processes' k-th local batches is
    exactly the single-process k-th global batch."""
    import numpy as np
    assert global_batch % num_processes == 0, \
        f"batch_size {global_batch} must divide over {num_processes} processes"
    h = global_batch // num_processes
    n_full = (n // global_batch) * global_batch
    return np.arange(n_full).reshape(-1, num_processes, h)[:, process_id, :].ravel()


def build_estimator(d, strategy="dp", device=None):
    """Tiny MLP regressor, JAX's example's (the same parameters from the
    same seed). ``strategy`` exercises the sharded layouts cross-process
    (e.g. "fsdp": parameters sharded over the ranks; "tp<N>":
    Megatron-style column+row parameter shards whose model-axis groups
    span the process boundary)."""
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.learn.estimator import Estimator

    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(d, 16)).astype("float32") * 0.3,
              "b1": np.zeros(16, "float32"),
              "w2": rng.normal(size=(16, 1)).astype("float32") * 0.3,
              "b2": np.zeros(1, "float32")}

    def apply_fn(p, x):
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    param_rules = None
    if "tp" in strategy:
        # Megatron MLP sharding: w1 column-parallel, w2 row-parallel
        param_rules = [("w1", (None, "model")), ("b1", ("model",)),
                       ("w2", ("model", None))]
    return Estimator.from_fn(apply_fn=apply_fn, params=params, loss="mse",
                             optimizer="sgd", strategy=strategy,
                             param_rules=param_rules, device=device)


def build_pipeline_estimator(d, n_devices, device=None):
    """Pipeline-parallel flavor: ``PipelinedMLP`` with one stage per
    rank over a pure ``pp<n_devices>`` mesh: the stage->stage activation
    handoff crosses the process boundary (the reference's whole
    multi-node story, Topology.scala:1145-1550, had no pipeline analog at
    all)."""
    import numpy as np
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.pipeline import PipelinedMLP

    pmesh = mesh_lib.build_mesh(axes=(mesh_lib.PIPE_AXIS,),
                                shape=[n_devices])
    model = PipelinedMLP(hidden=16, out_dim=1, n_stages=n_devices,
                         n_microbatches=2, mesh=pmesh)
    x0 = np.zeros((2, d), np.float32)
    params = model.init(0, x0)
    return Estimator.from_fn(
        apply_fn=model.apply, params=params, loss="mse", optimizer="sgd",
        strategy=f"pp{n_devices}", param_rules=model.param_rules(),
        device=device)


def run_worker(process_id, num_processes, coordinator, epochs, batch_size,
               strategy="dp", data_mode="array", device="cuda",
               backend=None):
    import torch.distributed as dist

    import analytics_zoo_tpu_torch as zoo
    own_group = backend == "gloo"
    if own_group:
        # the workers share one card: the context runs NCCL, one rank a
        # card, so each worker makes a gloo group itself and the context
        # adopts it
        import torch
        torch.cuda.set_device(torch.device(device))
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    ctx = zoo.init_orca_context(
        cluster_mode="multihost", coordinator_address=coordinator,
        num_processes=num_processes, process_id=process_id, device=device)
    assert dist.get_world_size() == num_processes
    assert len(ctx.devices) == 1  # one device a rank
    n_global = dist.get_world_size()

    x, y = make_data()
    # pure tp/pp layouts replicate the batch across processes: EVERY host
    # feeds the full global batch (ShardingStrategy.batch_feed_fraction
    # == 1.0), so the local shard is the whole dataset
    batch_replicated = not any(t in strategy for t in ("dp", "fsdp"))
    if batch_replicated:
        import numpy as np
        rows = np.arange(len(x))
    else:
        rows = local_rows(len(x), batch_size, process_id, num_processes)
    x_local, y_local = x[rows], y[rows]

    if strategy == "pp":
        est = build_pipeline_estimator(x.shape[1], n_global, device)
    else:
        est = build_estimator(x.shape[1], strategy, device)

    if data_mode == "streaming":
        # feed through the tiered out-of-core store: the multihost flavor
        # of the DiskFeatureSet path (FeatureSet.scala:556): each worker
        # streams ITS OWN shards window-by-window
        from analytics_zoo_tpu_torch.common.context import OrcaContext
        from analytics_zoo_tpu_torch.data.dataset import to_sharded_dataset
        from analytics_zoo_tpu_torch.data.shard import HostXShards
        OrcaContext.train_data_store = "DISK_2"
        shards = HostXShards.partition(
            {"x": x_local, "y": y_local}, num_shards=4)
        data = to_sharded_dataset(shards, feature_cols=["x"],
                                  label_cols=["y"])
        from analytics_zoo_tpu_torch.data.dataset import StreamingShardedDataset
        assert isinstance(data, StreamingShardedDataset), type(data)
    else:
        data = (x_local, y_local)

    history = est.fit(data, epochs=epochs, batch_size=batch_size,
                      shuffle=False)
    ev = est.evaluate((x_local, y_local), batch_size=batch_size)

    # Global loss is replicated across processes: every worker sees the
    # same numbers; process 0 reports.
    if process_id == 0:
        print("MULTIHOST_RESULT " + json.dumps(
            {"process_count": dist.get_world_size(),
             "global_devices": n_global,
             "strategy": strategy,
             "data_mode": data_mode,
             "loss": [float(v) for v in history["loss"]],
             "eval_loss": float(ev["loss"])}), flush=True)
    if own_group:
        # a clean exit: every rank reaches the teardown before any drops
        # the group it made
        del est
        zoo.stop_orca_context()
        dist.barrier()
        dist.destroy_process_group()
    return 0


def run_launcher(num_processes, epochs, batch_size, strategy="dp",
                 data_mode="array", device="cuda"):
    with socket.socket() as s:  # grab a free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    from analytics_zoo_tpu_torch.common.device import resolve_device
    dev = resolve_device(device)
    worker_args = ["--device", str(dev)]
    if dev.type == "cuda":
        # the workers share this host's one card over gloo
        worker_args = ["--device", f"cuda:{dev.index or 0}",
                       "--backend", "gloo"]
    env = dict(os.environ)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--process-id", str(i), "--num-processes", str(num_processes),
         "--coordinator", coordinator, "--epochs", str(epochs),
         "--batch-size", str(batch_size), "--strategy", strategy,
         "--data", data_mode] + worker_args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(num_processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    except subprocess.TimeoutExpired:
        # One worker hung (e.g. a peer died at the init barrier): kill the
        # rest so nothing is orphaned, and keep whatever output we have.
        for p in procs:
            if p.poll() is None:
                p.kill()
        while len(outs) < len(procs):
            outs.append(procs[len(outs)].communicate()[0] or "")
    ok = all(p.returncode == 0 for p in procs)
    for i, out in enumerate(outs):
        tag = "ok" if procs[i].returncode == 0 else f"rc={procs[i].returncode}"
        print(f"--- worker {i} ({tag}) ---")
        print("\n".join(out.splitlines()[-6:]))
    if not ok:
        return 1
    result = next(line for out in outs for line in out.splitlines()
                  if line.startswith("MULTIHOST_RESULT "))
    print(result)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--strategy", default="dp")
    ap.add_argument("--data", default="array",
                    choices=["array", "streaming"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["gloo"],
                    help="gloo: the workers share one card")
    args = ap.parse_args(argv)
    if args.process_id is None:
        return run_launcher(args.num_processes, args.epochs,
                            args.batch_size, args.strategy, args.data,
                            args.device)
    return run_worker(args.process_id, args.num_processes, args.coordinator,
                      args.epochs, args.batch_size, args.strategy, args.data,
                      args.device, args.backend)


if __name__ == "__main__":
    sys.exit(main())
