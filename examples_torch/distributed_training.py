"""Parallelism strategies on the PyTorch port (the counterpart of
examples/distributed_training.py; NEW vs the reference, which is
data-parallel only): the same model trained under dp, fsdp, dp+tp and a
dp+pp pipeline, and sequence-parallel attention under the ring and
Ulysses modes.

Where the JAX example makes 8 virtual CPU devices in one process, this
one starts 8 ranks with the port's launcher (``parallel/launch.py``), one
process a rank, over gloo. On the card every rank shares the one card
(``cuda:0``), which is how several ranks rehearse without a card each;
with ``--device cpu`` the ranks run on the host. Each rank feeds its
block of every global batch, and every rank reports the same global
losses; rank 0's lines are printed.

    python examples_torch/distributed_training.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

N_RANKS = 8


def rank_rows(est, n, batch):
    """This rank's rows of every global batch of ``batch`` rows: its
    block over the strategy's batch axes (all rows where the batch is
    replicated), as examples/multihost_launch.py's ``local_rows``."""
    blocks = est.strategy.batch_shards(est._mesh)
    if blocks <= 1:
        return np.arange(n)
    index = est._mesh.data_index(est.strategy.batch_axes())
    h = batch // blocks
    n_full = (n // batch) * batch
    return np.arange(n_full).reshape(-1, blocks, h)[:, index, :].ravel()


def run_rank(device):
    """One rank's part of every section; the lines rank 0 prints."""
    import torch

    from analytics_zoo_tpu_torch import (OrcaContext, init_orca_context,
                                         stop_orca_context)
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.pipeline import PipelinedMLP

    # full fp32 products: the ring and Ulysses attention below are held
    # to each other within JAX's fp32 limits, which TF32's 10-bit
    # rounding (the default precision's on the card) would break in
    # their different summation orders
    OrcaContext.default_matmul_precision = "float32"
    init_orca_context(cluster_mode="multihost", device=device)
    assert torch.distributed.get_world_size() == N_RANKS
    lines = []
    try:
        rng = np.random.RandomState(0)
        x = np.stack([rng.randint(1, 65, 512),
                      rng.randint(1, 33, 512)], 1).astype(np.float32)
        y = rng.randint(0, 5, 512).astype(np.int32)

        for strategy in ("dp", "fsdp", "dp2,tp4"):
            ncf = NeuralCF(user_count=64, item_count=32, class_num=5,
                           user_embed=8, item_embed=8, hidden_layers=(16, 8),
                           mf_embed=8)
            rules = NeuralCF.tp_param_rules() if "tp" in strategy else None
            ncf.model.set_strategy(strategy, param_rules=rules)
            ncf.compile(optimizer="adam",
                        loss="sparse_categorical_crossentropy", device=device)
            rows = rank_rows(ncf.model.estimator, len(x), 64)
            h = ncf.fit(x[rows], y[rows], batch_size=64, nb_epoch=1)
            mesh = ncf.model.estimator._mesh
            lines.append(f"{strategy:10s} mesh={dict(mesh.shape)} "
                         f"loss={h['loss'][0]:.4f}")
            mesh_lib.set_default_mesh(None)

        # pipeline parallel: 4 stages over the pipe axis, dp2 on top
        pmesh = mesh_lib.build_mesh(
            axes=(mesh_lib.DATA_AXIS, mesh_lib.PIPE_AXIS), shape=[2, 4])
        model = PipelinedMLP(hidden=16, out_dim=2, n_stages=4,
                             n_microbatches=2, mesh=pmesh)
        xb = rng.randn(256, 8).astype(np.float32)
        yb = (xb.sum(1) > 0).astype(np.int32)
        params = model.init(0, xb[:2])
        est = Estimator.from_fn(
            apply_fn=model.apply, params=params,
            loss="sparse_categorical_crossentropy_logits",
            optimizer="adam", strategy="dp2,pp4",
            param_rules=model.param_rules(), device=device)
        rows = rank_rows(est, len(xb), 64)
        h = est.fit((xb[rows], yb[rows]), epochs=2, batch_size=64)
        lines.append(f"{'dp2,pp4':10s} pipeline loss={h['loss'][-1]:.4f}")
        mesh_lib.set_default_mesh(None)

        # heterogeneous pipeline: embedding + blocks + LM head all INSIDE
        # the gpipe schedule (per-stage parameters packed into one matrix)
        from analytics_zoo_tpu_torch.parallel.pipeline import (
            PipelinedTransformerLM,
        )
        hmesh = mesh_lib.build_mesh(
            axes=(mesh_lib.DATA_AXIS, mesh_lib.PIPE_AXIS), shape=[2, 4])
        lm = PipelinedTransformerLM(vocab=32, d_model=16, n_heads=2,
                                    d_ff=32, seq_len=8, n_stages=4,
                                    n_microbatches=2, mesh=hmesh)
        tokens = rng.randint(0, 32, (64, 8)).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        lparams = lm.init(1, tokens[:2])
        lest = Estimator.from_fn(
            apply_fn=lm.apply, params=lparams,
            loss="sparse_categorical_crossentropy_logits",
            optimizer="adam", strategy="dp2,pp4",
            param_rules=lm.param_rules(), device=device)
        rows = rank_rows(lest, len(tokens), 32)
        h = lest.fit((tokens[rows], targets[rows]), epochs=2, batch_size=32)
        lines.append(f"{'dp2,pp4':10s} hetero-LM loss={h['loss'][-1]:.4f}")
        mesh_lib.set_default_mesh(None)

        # sequence parallelism: the same attention under the ring and
        # Ulysses all-to-all modes (context parallel over the seq axis)
        from analytics_zoo_tpu_torch.ops.ring_attention import ring_attention
        from analytics_zoo_tpu_torch.ops.ulysses import ulysses_attention
        from analytics_zoo_tpu_torch.parallel import collectives
        from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy

        smesh = ShardingStrategy.parse("dp2,sp4").build_mesh()
        q, k, v = (rng.randn(4, 32, 4, 8).astype(np.float32)
                   for _ in range(3))
        # each rank its rows over "data", the whole sequence
        gq, gk, gv = (torch.from_numpy(mesh_lib.block_of(
            t, smesh, ("data",))).to(device) for t in (q, k, v))
        ring = ring_attention(gq, gk, gv, mesh=smesh, causal=True,
                              batch_axis="data")
        uly = ulysses_attention(gq, gk, gv, mesh=smesh, causal=True,
                                batch_axis="data")
        ring, uly = (collectives.gather_axes(t, smesh, ["data"], 0)
                     .cpu().numpy() for t in (ring, uly))
        np.testing.assert_allclose(ring, uly, rtol=2e-4, atol=2e-5)
        lines.append(f"{'dp2,sp4':10s} ring == ulysses attention "
                     f"(max|Δ|={np.abs(ring - uly).max():.2e})")
    finally:
        stop_orca_context()
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    import torch

    from analytics_zoo_tpu_torch.common.device import resolve_device
    from analytics_zoo_tpu_torch.parallel.launch import launch

    dev = resolve_device(device)
    if dev.type == "cuda":
        # every rank on the one card, over gloo
        dev = torch.device("cuda", dev.index or 0)
    results = launch(run_rank, N_RANKS, args=(str(dev),), device=str(dev),
                     backend="gloo")
    assert all(r == results[0] for r in results), \
        "ranks disagree on the global losses"
    for line in results[0]:
        print(line)


if __name__ == "__main__":
    main()
