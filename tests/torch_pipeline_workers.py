"""Rank-side functions of the port's pipeline-parallel tests
(``tests/test_torch_pipeline.py``).

``parallel/launch.py`` runs them on gloo ranks on the CPU; each returns
JSON. They import torch and the port only, never JAX: the test file
computes JAX's side in the test process and compares.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_multirank_workers import _context, _stop, local_rows  # noqa: E402


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _tree(tree):
    """Nested lists (JSON) as tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _lists(tree):
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                      else tree).tolist()


def _mesh(shape):
    from analytics_zoo_tpu_torch.parallel import mesh as M
    return M.build_mesh(axes=(M.DATA_AXIS, M.PIPE_AXIS), shape=shape)


def _data_block(mesh, x):
    """This rank's rows of a global batch: its block over ``data``."""
    from analytics_zoo_tpu_torch.parallel import mesh as M
    dp = M.mesh_axis_size(mesh, M.DATA_AXIS)
    n = len(x) // dp
    i = mesh.coord(M.DATA_AXIS)
    return x[i * n:(i + 1) * n]


def _sum_ranks(t, mesh):
    from analytics_zoo_tpu_torch.parallel import collectives as C
    return C.all_reduce_(t.detach().clone(), mesh, mesh.axis_names)


def pipeline_group(cases):
    """Every case of one rank group, in order."""
    _context()
    try:
        return {c["name"]: globals()[c["fn"]](c) for c in cases}
    finally:
        _stop()


def gpipe_forward(case):
    """JAX ``TestGpipe``'s forward cases on "dp2,pp4": this rank's rows of
    the output for each number of microbatches."""
    from analytics_zoo_tpu_torch.parallel.pipeline import gpipe
    mesh = _mesh([2, 4])
    stacked = _tree(case["stacked"])
    x = _data_block(mesh, _t(case["x"]))

    def stage_fn(p, h):
        h = h @ p["w"]
        return torch.tanh(h + p["b"] if "b" in p else h)

    outs = {str(m): gpipe(stage_fn, stacked, x, mesh=mesh,
                          n_microbatches=m).tolist()
            for m in case["micro"]}
    return {"outs": outs, "data": mesh.coord("data"),
            "pipe": mesh.coord("pipe")}


def gpipe_grads(case):
    """JAX ``test_gradients_flow_through_pipeline``: the gradient of
    ``mean(out ** 2)`` over the global batch with respect to the whole
    stack, summed over the ranks, and the sequential one on this rank."""
    from analytics_zoo_tpu_torch.parallel.pipeline import gpipe
    mesh = _mesh([2, 4])
    w = _t(case["w"]).requires_grad_()
    x_all = _t(case["x"])
    x = _data_block(mesh, x_all)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])

    out = gpipe(stage_fn, {"w": w}, x, mesh=mesh,
                n_microbatches=case["micro"])
    # this rank's share of the global mean, once over the pipe copies
    loss = (out ** 2).sum() / (x_all.shape[0] * out.shape[1]) / 4
    (g,) = torch.autograd.grad(loss, [w])
    g = _sum_ranks(g, mesh)
    ws = w.detach().clone().requires_grad_()
    h = x_all
    for s in range(ws.shape[0]):
        h = stage_fn({"w": ws[s]}, h)
    (gs,) = torch.autograd.grad((h ** 2).mean(), [ws])
    return {"grad": g.tolist(), "seq_grad": gs.tolist()}


def _loss_grads(est, model, params, x, y, loss):
    """One batch's loss and gradients through the estimator on this
    rank (whole, gathered), and the sequential model's on the whole
    batch."""
    from analytics_zoo_tpu_torch.learn import losses
    mesh = est._mesh
    blocks = est._batch_shards
    idx = mesh.data_index(est.strategy.batch_axes())
    per = len(x) // blocks
    xl, yl = x[idx * per:(idx + 1) * per], y[idx * per:(idx + 1) * per]
    got, grads = est._loss_and_grads(xl, yl)
    whole = {n: est._whole(n, g) for n, g in zip(est._names, grads)}
    seq = {k: v.detach().clone().requires_grad_() for k, v in
           _flat(params).items()}
    out = model.apply_sequential(_nest(seq), torch.as_tensor(x))
    want = losses.get(loss)(torch.as_tensor(y), out).mean()
    gs = torch.autograd.grad(want, list(seq.values()))
    return {"loss": float(got), "seq_loss": float(want),
            "grads": {n.replace(".", "/"): g.tolist()
                      for n, g in whole.items()},
            "seq_grads": {k: g.tolist() for k, g in zip(seq, gs)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _rows_held(est):
    return {n: list(s.local_shape) for n, s in est._shards.items()}


def mlp_fit(case):
    """JAX ``test_estimator_trains_pipelined_mlp`` ("dp2,pp4", Adam), one
    batch's gradients against the sequential model's, and the snapshot."""
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.parallel.pipeline import PipelinedMLP
    mesh = _mesh([2, 4])
    model = PipelinedMLP(hidden=8, out_dim=2, n_stages=4, n_microbatches=2,
                         mesh=mesh)
    params = _tree(case["params"])
    x = np.asarray(case["x"], np.float32)
    y = np.asarray(case["y"], np.int32)
    est = Estimator.from_fn(
        apply_fn=model.apply, params=params,
        loss="sparse_categorical_crossentropy_logits", optimizer="adam",
        strategy=case["strategy"], param_rules=model.param_rules(),
        model_dir=case.get("model_dir"), device="cpu")
    out = {"step": _loss_grads(est, model, params, x[:16], y[:16],
                               "sparse_categorical_crossentropy_logits")}
    blocks = est._batch_shards
    rows = local_rows(len(x), 16, est._mesh.data_index(
        est.strategy.batch_axes()), blocks)
    h1 = est.fit((x[rows], y[rows]), epochs=1, batch_size=16, shuffle=False)
    h2 = est.fit((x[rows], y[rows]), epochs=8, batch_size=16, shuffle=False)
    out.update(h1=h1["loss"], h2=h2["loss"], held=_rows_held(est),
               mesh=est._mesh.shape, covered=sorted(
                   set(est._shards) - set(est._gathered)),
               params=_lists(est.gathered_state_dict()))
    return out


def lm_model(case, mesh):
    from analytics_zoo_tpu_torch.parallel.pipeline import (
        PipelinedTransformerLM)
    return PipelinedTransformerLM(
        vocab=case["vocab"], d_model=16, n_heads=2, d_ff=32,
        seq_len=case["seq"], n_stages=4, n_microbatches=2,
        mesh=mesh).set_layout()


def lm_forward_grads(case):
    """JAX ``TestHeterogeneousPipeline``: the pipelined forward against
    ``apply_sequential`` (this rank's rows), and the gradient of the
    next-token loss through the estimator against the sequential one."""
    from analytics_zoo_tpu_torch.learn import Estimator
    mesh = _mesh([2, 4])
    model = lm_model(case, mesh)
    pipe = _t(case["pipe"])
    tokens = np.asarray(case["tokens"], np.int32)
    mine = _data_block(mesh, torch.as_tensor(tokens))
    got = model.apply({"pipe": pipe}, mine)
    want = model.apply_sequential({"pipe": pipe}, mine)
    targets = np.roll(tokens, -1, axis=1)
    est = Estimator.from_fn(
        apply_fn=model.apply, params={"pipe": pipe},
        loss="sparse_categorical_crossentropy_logits", optimizer="adam",
        strategy="dp2,pp4", param_rules=model.param_rules(), device="cpu")
    step = _loss_grads(est, model, {"pipe": pipe}, tokens, targets,
                       "sparse_categorical_crossentropy_logits")
    return {"out": got.tolist(), "seq_out": want.tolist(),
            "data": mesh.coord("data"), "step": step,
            "held": _rows_held(est)}


def lm_fit(case):
    """JAX ``test_estimator_trains_hetero_lm_dp_pp``: "dp2,pp4" training
    of the LM; each rank holds its row of the packed matrix."""
    from analytics_zoo_tpu_torch.learn import Estimator
    mesh = _mesh([2, 4])
    model = lm_model(case, mesh)
    tokens = np.asarray(case["tokens"], np.int32)
    targets = np.roll(tokens, -1, axis=1)
    est = Estimator.from_fn(
        apply_fn=model.apply, params={"pipe": _t(case["pipe"])},
        loss="sparse_categorical_crossentropy_logits", optimizer="adam",
        strategy="dp2,pp4", param_rules=model.param_rules(), device="cpu")
    rows = local_rows(len(tokens), 16, est._mesh.data_index(
        est.strategy.batch_axes()), est._batch_shards)
    h1 = est.fit((tokens[rows], targets[rows]), epochs=2, batch_size=16,
                 shuffle=False)
    h2 = est.fit((tokens[rows], targets[rows]), epochs=10, batch_size=16,
                 shuffle=False)
    return {"h1": h1["loss"], "h2": h2["loss"], "held": _rows_held(est),
            "whole": list(est.gathered_state_dict()["pipe"].shape)}


def mh_pipeline(case):
    """JAX ``examples/multihost_launch.build_pipeline_estimator``'s model,
    data and SGD under ``case["strategy"]`` ("pp8" or "pp" on 8 ranks)."""
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.parallel.pipeline import PipelinedMLP
    mesh = _mesh([1, 8])
    model = PipelinedMLP(hidden=16, out_dim=1, n_stages=8, n_microbatches=2,
                         mesh=mesh)
    x = np.asarray(case["x"], np.float32)
    y = np.asarray(case["y"], np.float32)
    est = Estimator.from_fn(
        apply_fn=model.apply, params=_tree(case["params"]), loss="mse",
        optimizer="sgd", strategy=case["strategy"],
        param_rules=model.param_rules(), device="cpu")
    hist = est.fit((x, y), epochs=case["epochs"], batch_size=case["batch"],
                   shuffle=False)
    return {"loss": hist["loss"], "held": _rows_held(est),
            "mesh": est._mesh.shape}
