"""Pipeline parallelism in the port against the JAX package, on the CPU
(mirrors JAX ``tests/test_pipeline.py`` and ``tests/test_multihost.py::
test_two_process_pipeline_spans_processes``).

The port's stages are gloo ranks on the host (``parallel/launch.py``, the
rank functions in ``tests/torch_pipeline_workers.py``, no JAX): one group
of 8 ranks, launched once for the module, runs every multi-rank case.
JAX runs in this process on its 8 virtual CPU devices, on the same numpy
inputs and JAX's own initial parameters:

- ``gpipe`` on "dp2,pp4" against the stages run one after another and
  against JAX's ``gpipe`` (1e-5), with 1, 2 and 4 microbatches; its
  gradient, summed over the ranks, against the sequential one and JAX's
  ``jax.grad`` (1e-5), every stage receiving signal;
- the three errors (the batch does not divide, the stage count is wrong,
  no pipe axis), raised before any collective;
- ``PipelinedMLP`` and ``PipelinedTransformerLM`` through
  ``Estimator.from_fn`` under "dp2,pp4": one batch's loss and gradients
  against ``apply_sequential`` and JAX's ``jax.grad`` (1e-5); the losses
  fall; each rank holds its stage's row only; the snapshot is JAX's
  layout, gathered to rank 0;
- the LM's pipelined forward against ``apply_sequential`` and JAX's
  pipelined forward (1e-5), and ``pack_stage_params`` laying out JAX's
  packed matrix;
- JAX's multihost pipeline (``PipelinedMLP`` over "pp8" and "pp", SGD):
  the loss history within JAX's ``atol=2e-4`` of JAX's 8-device fit.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.parallel import mesh as M
from analytics_zoo_tpu_torch.parallel.launch import launch
from analytics_zoo_tpu_torch.parallel.pipeline import (PipelinedMLP,
                                                       PipelinedTransformerLM,
                                                       gpipe,
                                                       pack_stage_params,
                                                       stack_stage_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_pipeline_workers.py")
LM = dict(vocab=17, seq=8)
MH_EPOCHS, MH_BATCH = 2, 32


@pytest.fixture(autouse=True)
def _tmp_log_dir(tmp_path, monkeypatch):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "tb"))


def _lists(tree):
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    return np.asarray(tree).tolist()


def _ref_forward(stages_w, stages_b, h):
    for w, b in zip(stages_w, stages_b):
        h = np.tanh(h @ w + b)
    return h


@pytest.fixture(scope="module")
def jax_side():
    """JAX's side of every case, on its 8 virtual devices."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from analytics_zoo_tpu.common import context as jctx
    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.parallel import pipeline as jp
    out = {}
    jctx.stop_orca_context()
    jctx.init_orca_context(cluster_mode="local")
    try:
        mesh = jmesh.build_mesh(axes=(jmesh.DATA_AXIS, jmesh.PIPE_AXIS),
                                shape=[2, 4])
        # TestGpipe.test_matches_sequential_execution
        rng = np.random.RandomState(0)
        ws = [rng.randn(8, 8).astype(np.float32) * 0.3 for _ in range(4)]
        bs = [rng.randn(8).astype(np.float32) * 0.1 for _ in range(4)]
        x = rng.randn(16, 8).astype(np.float32)
        stacked = jp.stack_stage_params(
            [{"w": w, "b": b} for w, b in zip(ws, bs)])
        out["fwd"] = dict(ws=ws, bs=bs, x=x, stacked=stacked, jax=np.asarray(
            jp.gpipe(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), stacked, x,
                     mesh=mesh, n_microbatches=4)))
        # test_single_microbatch_and_many
        rng = np.random.RandomState(1)
        many = jp.stack_stage_params(
            [{"w": rng.randn(4, 4).astype(np.float32) * 0.3}
             for _ in range(4)])
        xm = rng.randn(8, 4).astype(np.float32)
        out["many"] = dict(stacked=many, x=xm, jax={m: np.asarray(jp.gpipe(
            lambda p, h: jnp.tanh(h @ p["w"]), many, xm, mesh=mesh,
            n_microbatches=m)) for m in (1, 2, 4)})
        # test_gradients_flow_through_pipeline
        rng = np.random.RandomState(2)
        gst = jp.stack_stage_params(
            [{"w": rng.randn(4, 4).astype(np.float32) * 0.3}
             for _ in range(4)])
        xg = rng.randn(8, 4).astype(np.float32)

        def gloss(params):
            o = jp.gpipe(lambda p, h: jnp.tanh(h @ p["w"]), params, xg,
                         mesh=mesh, n_microbatches=2)
            return (o ** 2).mean()
        out["grads"] = dict(w=gst["w"], x=xg,
                            jax=np.asarray(jax.grad(gloss)(gst)["w"]))
        # TestPipelinedTraining: JAX's model, init and data
        mlp = jp.PipelinedMLP(hidden=8, out_dim=2, n_stages=4,
                              n_microbatches=2, mesh=mesh)
        rng = np.random.RandomState(0)
        x = rng.randn(64, 4).astype(np.float32)
        y = (x.sum(1) > 0).astype(np.int32)
        params = jax.device_get(mlp.init(jax.random.PRNGKey(0), x[:2]))

        def mloss(p):
            lp = jax.nn.log_softmax(mlp.apply(p, x[:16]))
            return -jnp.take_along_axis(lp, y[:16, None], -1).mean()
        mgrads = jax.device_get(jax.grad(mloss)(params))
        est = JEstimator.from_fn(
            apply_fn=mlp.apply, params=params,
            loss="sparse_categorical_crossentropy_logits",
            optimizer="adam", strategy="dp2,pp4",
            param_rules=mlp.param_rules())
        h1 = est.fit((x, y), epochs=1, batch_size=16, shuffle=False)
        h2 = est.fit((x, y), epochs=8, batch_size=16, shuffle=False)
        out["mlp"] = dict(params=params, x=x, y=y, grads=mgrads,
                          h1=h1["loss"], h2=h2["loss"])
        # TestHeterogeneousPipeline
        lm = jp.PipelinedTransformerLM(
            vocab=LM["vocab"], d_model=16, n_heads=2, d_ff=32,
            seq_len=LM["seq"], n_stages=4, n_microbatches=2, mesh=mesh)
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, LM["vocab"], (16, LM["seq"])) \
            .astype(np.int32)
        lparams = lm.init(jax.random.PRNGKey(1), tokens[:2])
        targets = np.roll(tokens, -1, axis=1)

        def lloss(p):
            lp = jax.nn.log_softmax(lm.apply_sequential(p, tokens))
            return -jnp.take_along_axis(lp, targets[..., None], -1).mean()
        out["lm"] = dict(
            pipe=np.asarray(lparams["pipe"]), tokens=tokens,
            out=np.asarray(lm.apply(lparams, tokens)),
            grads=np.asarray(jax.grad(lloss)(lparams)["pipe"]),
            loss=float(lloss(lparams)),
            stages=jax.device_get(lm._stage_param_list(
                jax.random.PRNGKey(1))))
        # test_multihost.py's pipeline: its model, data and SGD
        sys.path.insert(0, os.path.join(REPO, "examples"))
        import multihost_launch as mh
        xh, yh = mh.make_data()
        pest = mh.build_pipeline_estimator(xh.shape[1], 8)
        pparams = jax.device_get(pest.adapter.params)
        ph = pest.fit((xh, yh), epochs=MH_EPOCHS, batch_size=MH_BATCH,
                      shuffle=False)
        out["mh"] = dict(x=xh, y=yh, params=pparams, loss=ph["loss"])
    finally:
        jctx.stop_orca_context()
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The group of 8 ranks, launched once: every rank's results."""
    ckpt = str(tmp_path_factory.mktemp("pp_ckpt"))
    f, g, m, lm, mh = (jax_side[k] for k in
                       ("fwd", "grads", "mlp", "lm", "mh"))
    many = jax_side["many"]
    cases = [
        dict(name="fwd", fn="gpipe_forward", stacked=_lists(f["stacked"]),
             x=f["x"].tolist(), micro=[4]),
        dict(name="many", fn="gpipe_forward",
             stacked=_lists(many["stacked"]), x=many["x"].tolist(),
             micro=[1, 2, 4]),
        dict(name="grads", fn="gpipe_grads", w=g["w"].tolist(),
             x=g["x"].tolist(), micro=2),
        dict(name="mlp", fn="mlp_fit", params=_lists(m["params"]),
             x=m["x"].tolist(), y=m["y"].tolist(), strategy="dp2,pp4",
             model_dir=ckpt),
        dict(name="lm", fn="lm_forward_grads", pipe=lm["pipe"].tolist(),
             tokens=lm["tokens"].tolist(), **LM),
        dict(name="lm_fit", fn="lm_fit", pipe=lm["pipe"].tolist(),
             tokens=lm["tokens"].tolist(), **LM)]
    for strategy in ("pp8", "pp"):
        cases.append(dict(name=f"mh_{strategy}", fn="mh_pipeline",
                          strategy=strategy, params=_lists(mh["params"]),
                          x=mh["x"].tolist(), y=mh["y"].tolist(),
                          epochs=MH_EPOCHS, batch=MH_BATCH))
    return {"ranks": launch(f"{WORKERS}:pipeline_group", 8, args=(cases,),
                            timeout=600),
            "ckpt": ckpt}


def _rows(results, name, key):
    """The global output from each rank's rows (the data blocks), every
    pipe rank's copy of them the same."""
    by_block = {}
    for r in results:
        rec = r[name]
        got = np.asarray(rec[key] if key in rec else rec["outs"][key])
        prev = by_block.setdefault(rec["data"], got)
        np.testing.assert_array_equal(got, prev)
    return np.concatenate([by_block[d] for d in sorted(by_block)])


class TestGpipe:
    def test_matches_sequential_execution(self, ranks, jax_side):
        f = jax_side["fwd"]
        got = _rows(ranks["ranks"], "fwd", "4")
        want = _ref_forward(f["ws"], f["bs"], f["x"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, f["jax"], rtol=0, atol=1e-5)

    def test_single_microbatch_and_many(self, ranks, jax_side):
        outs = {m: _rows(ranks["ranks"], "many", str(m))
                for m in (1, 2, 4)}
        np.testing.assert_allclose(outs[1], outs[2], rtol=0, atol=1e-5)
        np.testing.assert_allclose(outs[1], outs[4], rtol=0, atol=1e-5)
        for m, got in outs.items():
            np.testing.assert_allclose(got, jax_side["many"]["jax"][m],
                                       rtol=0, atol=1e-5)

    def test_gradients_flow_through_pipeline(self, ranks, jax_side):
        got = [np.asarray(r["grads"]["grad"]) for r in ranks["ranks"]]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])
        gw = got[0]
        assert gw.shape == (4, 4, 4)
        for s in range(4):
            assert np.abs(gw[s]).max() > 1e-8, f"stage {s} got zero grad"
        np.testing.assert_allclose(
            gw, np.asarray(ranks["ranks"][0]["grads"]["seq_grad"]),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(gw, jax_side["grads"]["jax"], rtol=0,
                                   atol=1e-5)

    def test_batch_not_divisible_raises(self):
        mesh = M.build_mesh(axes=(M.DATA_AXIS, M.PIPE_AXIS), shape=[1, 4],
                            devices=[torch.device("cpu")] * 4,
                            set_default=False)
        stacked = stack_stage_params(
            [{"w": np.eye(4, dtype=np.float32)} for _ in range(4)])
        with pytest.raises(ValueError, match="divisible"):
            gpipe(lambda p, h: h @ p["w"], stacked,
                  torch.zeros((10, 4)), mesh=mesh, n_microbatches=4)

    def test_wrong_stage_count_raises(self):
        mesh = M.build_mesh(axes=(M.DATA_AXIS, M.PIPE_AXIS), shape=[1, 4],
                            devices=[torch.device("cpu")] * 4,
                            set_default=False)
        stacked = stack_stage_params(
            [{"w": np.eye(4, dtype=np.float32)} for _ in range(3)])
        with pytest.raises(ValueError, match="pipe size"):
            gpipe(lambda p, h: h @ p["w"], stacked,
                  torch.zeros((8, 4)), mesh=mesh, n_microbatches=2)

    def test_no_pipe_axis_raises(self):
        mesh = M.build_mesh(axes=(M.DATA_AXIS,), shape=[1],
                            devices=[torch.device("cpu")],
                            set_default=False)
        stacked = stack_stage_params(
            [{"w": np.eye(4, dtype=np.float32)} for _ in range(4)])
        with pytest.raises(ValueError, match="pipe"):
            gpipe(lambda p, h: h @ p["w"], stacked,
                  torch.zeros((8, 4)), mesh=mesh, n_microbatches=2)


def _check_step(step, jax_grads, flat=lambda k: k):
    """One batch through the estimator on every rank: the loss and every
    gradient against the sequential model's and JAX's (1e-5)."""
    assert abs(step["loss"] - step["seq_loss"]) <= 1e-5
    for k, want in step["seq_grads"].items():
        got = np.asarray(step["grads"][k])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, np.asarray(jax_grads[flat(k)]),
                                   rtol=0, atol=1e-5, err_msg=k)


class TestPipelinedTraining:
    def test_estimator_trains_pipelined_mlp(self, ranks, jax_side):
        """JAX ``test_estimator_trains_pipelined_mlp``: "dp2,pp4" through
        ``from_fn``; the loss falls, the gradients are the sequential
        model's and JAX's, and each rank holds its stage's row only."""
        m = jax_side["mlp"]
        jgrads = {"w_in": m["grads"]["w_in"], "w_out": m["grads"]["w_out"],
                  "stages/w": m["grads"]["stages"]["w"],
                  "stages/b": m["grads"]["stages"]["b"]}
        first = ranks["ranks"][0]["mlp"]
        for r in ranks["ranks"]:
            rec = r["mlp"]
            assert rec["h1"] + rec["h2"] == first["h1"] + first["h2"]
            assert rec["held"] == {"stages.w": [1, 8, 8],
                                   "stages.b": [1, 8]}
            _check_step(rec["step"], jgrads)
        assert first["h2"][-1] < first["h1"][0]
        assert first["mesh"] == {"data": 2, "pipe": 4}
        assert first["covered"] == ["stages.b", "stages.w"]
        # the same fit as JAX's from the same parameters
        np.testing.assert_allclose(first["h1"] + first["h2"],
                                   m["h1"] + m["h2"], rtol=0, atol=2e-4)

    def test_snapshot_is_jax_layout(self, ranks, jax_side):
        """The fit's snapshot, gathered to rank 0: JAX's ``params`` tree
        with the whole ``[S, ...]`` stage stack, the ranks' values."""
        from flax import serialization
        found = sorted(glob.glob(os.path.join(ranks["ckpt"], "ckpt-*")),
                       key=lambda p: int(p.rsplit("-", 1)[1]))
        assert found, os.listdir(ranks["ckpt"])
        with open(os.path.join(found[-1], "state.msgpack"), "rb") as fh:
            state = serialization.msgpack_restore(fh.read())
        params = state["params"]
        shapes = {"w_in": (4, 8), "w_out": (8, 2),
                  "stages": {"w": (4, 8, 8), "b": (4, 8)}}
        got = {"w_in": params["w_in"].shape, "w_out": params["w_out"].shape,
               "stages": {k: params["stages"][k].shape
                          for k in params["stages"]}}
        assert got == shapes
        whole = ranks["ranks"][0]["mlp"]["params"]
        np.testing.assert_array_equal(params["stages"]["w"],
                                      np.asarray(whole["stages.w"]))
        assert int(state["step"]) == 36


class TestHeterogeneousPipeline:
    def test_matches_sequential_execution(self, ranks, jax_side):
        """The pipelined forward against ``apply_sequential`` and JAX's
        pipelined forward from JAX's packed parameters."""
        lm = jax_side["lm"]
        got = _rows(ranks["ranks"], "lm", "out")
        seq = _rows(ranks["ranks"], "lm", "seq_out")
        assert got.shape == (16, 8, 17)
        np.testing.assert_allclose(got, seq, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, lm["out"], rtol=0, atol=1e-5)

    def test_gradients_match_sequential(self, ranks, jax_side):
        """The next-token loss's gradient through the estimator ("dp2,pp4")
        against ``apply_sequential``'s and JAX's ``jax.grad`` (1e-5)."""
        lm = jax_side["lm"]
        for r in ranks["ranks"]:
            step = r["lm"]["step"]
            assert abs(step["loss"] - lm["loss"]) <= 1e-5
            _check_step(step, {"pipe": lm["grads"]})

    def test_estimator_trains_hetero_lm_dp_pp(self, ranks):
        first = ranks["ranks"][0]["lm_fit"]
        assert first["h2"][-1] < first["h1"][0]
        for r in ranks["ranks"]:
            rec = r["lm_fit"]
            assert rec["h1"] + rec["h2"] == first["h1"] + first["h2"]
            assert rec["held"]["pipe"][0] == 1
            assert rec["whole"] == [4, rec["held"]["pipe"][1]]

    def test_pack_stage_params_roundtrip(self):
        stages = [{"a": np.arange(4, dtype=np.float32)},
                  {"b": np.ones((2, 3), np.float32),
                   "c": np.zeros(2, np.float32)},
                  {"d": np.full((5,), 2.0, np.float32)}]
        packed, unravels, sizes = pack_stage_params(stages)
        assert packed.shape == (3, 8)
        for s, st in enumerate(stages):
            rec = unravels[s](torch.from_numpy(packed[s][:sizes[s]]))
            assert set(rec) == set(st)
            for k in st:
                np.testing.assert_array_equal(rec[k].numpy(), st[k])

    def test_packed_layout_is_jax(self, jax_side):
        """The port packs JAX's stage trees into JAX's matrix, and its
        model's layout (``set_layout``) unravels it."""
        lm = jax_side["lm"]
        packed, _, sizes = pack_stage_params(lm["stages"])
        np.testing.assert_array_equal(packed, lm["pipe"])
        model = PipelinedTransformerLM(
            vocab=LM["vocab"], d_model=16, n_heads=2, d_ff=32,
            seq_len=LM["seq"], n_stages=4, n_microbatches=2).set_layout()
        assert model._sizes == sizes


@pytest.mark.parametrize("strategy", ["pp8", "pp"])
def test_multihost_pipeline_matches_jax(ranks, jax_side, strategy):
    """JAX ``test_two_process_pipeline_spans_processes``: ``PipelinedMLP``
    with one stage a rank over 8 ranks (every stage hand-off crosses a
    process), JAX's losses within its ``atol=2e-4``."""
    name = f"mh_{strategy}"
    first = ranks["ranks"][0][name]
    assert first["loss"][-1] < first["loss"][0]
    assert first["mesh"] == {"data": 1, "pipe": 8}
    for r in ranks["ranks"]:
        assert r[name]["loss"] == first["loss"]
        assert r[name]["held"]["stages.w"] == [1, 16, 16]
    np.testing.assert_allclose(first["loss"], jax_side["mh"]["loss"],
                               rtol=0, atol=2e-4)


def test_pipelined_mlp_sequential_is_stacked_stages():
    """``apply_sequential`` (the port's addition for the MLP) is the
    stages one after another."""
    model = PipelinedMLP(hidden=8, out_dim=2, n_stages=3)
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    params = model.init(torch.Generator().manual_seed(0), x)
    h = x @ params["w_in"].numpy()
    h = _ref_forward(params["stages"]["w"].numpy(),
                     params["stages"]["b"].numpy(), h)
    np.testing.assert_allclose(
        model.apply_sequential(params, torch.from_numpy(x)).numpy(),
        h @ params["w_out"].numpy(), rtol=0, atol=1e-6)
