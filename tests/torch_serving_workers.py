"""Rank-side functions of the port's sharded-serving tests
(``tests/test_torch_sharded_serving.py``).

``parallel/launch.py`` runs them on gloo ranks on the CPU; each returns
JSON. Every case builds its sharded model on every rank (collective);
then rank 0 serves and checks while the other ranks follow until rank 0
releases them. They import torch and the port only, never JAX.
"""

import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_multirank_workers import _context, _stop  # noqa: E402

RULES = [(r"kernel", (None, "model"))]


def serve_group(cases):
    """Every case of one rank group, in order."""
    _context()
    try:
        return {c["name"]: globals()[c["fn"]](c) for c in cases}
    finally:
        _stop()


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def _misses(name="inference_model"):
    from analytics_zoo_tpu_torch.common import telemetry
    fam = telemetry.snapshot().get("zoo_jit_cache_misses_total", {})
    return float(fam.get(f"fn={name}", 0.0)) if isinstance(fam, dict) \
        else 0.0


def _lead(target, body):
    """Rank 0 runs ``body()`` and releases the followers (``target.
    unshard`` or ``.close``); the others follow. Every rank's record."""
    if _rank() == 0:
        try:
            out = body()
        finally:
            (getattr(target, "unshard", None) or target.close)()
        return out
    before = _misses(getattr(target, "name", "inference_model"))
    served = target.follow()
    return {"served": served, "new_misses": _misses(getattr(
        target, "name", "inference_model")) - before}


def _mlp(params):
    from analytics_zoo_tpu_torch.convert import flax_to_state_dict
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras.layers import Dense
    m = Sequential()
    m.add(Dense(32, input_shape=(16,), activation="relu", name="fc1"))
    m.add(Dense(8, name="fc2"))
    if params is not None:
        m.module.load_state_dict(flax_to_state_dict(_arrays(params)))
    return m


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def executable(case):
    """JAX's ``ShardedExecutable`` cases: dispatch against the unsharded
    module, the per-rank bytes, the gauge, replicated without rules, and
    warm rungs dispatching without a new miss."""
    from analytics_zoo_tpu_torch.common import telemetry
    from analytics_zoo_tpu_torch.parallel.sharded_executable import (
        ShardedExecutable)
    m = _mlp(None)
    flax = _arrays(case["params"])
    xb = np.asarray(case["x"], np.float32)
    ex = ShardedExecutable(m.module, flax, "tp2", param_rules=RULES,
                           device="cpu", name="exec_case")
    shapes = {n: list(p.shape) for n, p in ex.module.named_parameters()}

    def body():
        from analytics_zoo_tpu_torch.convert import flax_to_state_dict
        plain = m.module
        plain.load_state_dict(flax_to_state_dict(flax))
        with torch.no_grad():
            want = plain(torch.tensor(xb)).numpy()
        got = ex(xb).numpy()
        hbm = ex.shard_hbm_bytes()
        fam = telemetry.snapshot().get("zoo_shard_hbm_bytes", {})
        spec = (((16,), np.dtype(np.float32)),)
        ex.warm(spec, (2, 4, 8), block=True)
        base = _misses("exec_case")
        outs = [list(ex(np.zeros((r, 16), np.float32)).shape)
                for r in (2, 4, 8)]
        return {"err": float(np.abs(got - want).max()), "hbm": hbm,
                "total": ex.total_param_bytes(), "n_shards": ex.n_shards,
                "gauge": sorted(fam) if isinstance(fam, dict) else [],
                "warm_outs": outs, "new_misses": _misses("exec_case") - base,
                "batch_spec": list(ex.batch_sharding(2))}
    out = _lead(ex, body)
    out["shapes"] = shapes
    rep = ShardedExecutable(m.module, flax, "tp2", device="cpu",
                            name="exec_rep")
    out["replicated"] = _lead(rep, lambda: {
        "hbm": rep.shard_hbm_bytes(publish=False),
        "total": rep.total_param_bytes()})
    out["fn"] = _fn_case(flax, xb)
    return out


def _fn_case(flax, xb):
    """JAX's own form: a pure ``fn(params, x)`` over the flax tree."""
    from analytics_zoo_tpu_torch.parallel.sharded_executable import (
        ShardedExecutable)

    def apply(p, x):
        h = torch.relu(x @ p["fc1"]["kernel"] + p["fc1"]["bias"])
        return h @ p["fc2"]["kernel"] + p["fc2"]["bias"]

    ex = ShardedExecutable(apply, flax, "tp2", param_rules=RULES,
                           device="cpu", name="exec_fn")
    shapes = {n: list(p.shape) for n, p in ex.module.named_parameters()}

    def body():
        t = {k: {n: torch.tensor(v) for n, v in d.items()}
             for k, d in flax.items()}
        want = apply(t, torch.tensor(xb)).numpy()
        return {"err": float(np.abs(ex(xb).numpy() - want).max()),
                "hbm": ex.shard_hbm_bytes(publish=False),
                "total": ex.total_param_bytes(),
                "gathered": sorted(ex.gathered)}
    out = _lead(ex, body)
    out["shapes"] = shapes
    return out


def reshard(case):
    """``shard`` on a sharded model raises on every rank; after
    ``unshard`` (rank 0) and a new load (the follower, which kept only
    its blocks) the model shards again from its whole parameters."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    m = _mlp(case["params"])
    xb = np.asarray(case["x"], np.float32)
    want = InferenceModel(device="cpu").load_zoo(m).predict(xb)
    im = InferenceModel(device="cpu").load_zoo(m)
    im.shard("tp2", param_rules=RULES)
    try:
        im.shard("tp2", param_rules=RULES)
        again = None
    except RuntimeError as e:
        again = str(e)
    out = {"again": again}
    out["first"] = _lead(im, lambda: {
        "err": float(np.abs(im.predict(xb) - want).max())})
    try:
        im.predict(xb)
        out["after"] = "predicted"
    except RuntimeError as e:
        out["after"] = str(e)
    if _rank() == 0:
        out["whole"] = {n: list(p.shape)
                        for n, p in im._module.named_parameters()}
    else:
        im.load_zoo(m)
    im.shard("tp2", param_rules=RULES)
    out["shapes"] = {n: list(p.shape)
                     for n, p in im._sharded.module.named_parameters()}
    out["second"] = _lead(im, lambda: {
        "err": float(np.abs(im.predict(xb) - want).max())})
    return out


def inference_model(case):
    """JAX's ``InferenceModel`` cases: ``shard`` against the unsharded
    predict, ``shard_info``, and a warmed ladder dispatching with the
    misses flat on every rank; then ``unshard``."""
    from analytics_zoo_tpu_torch.common import compile_ahead
    from analytics_zoo_tpu_torch.inference import InferenceModel
    m = _mlp(case["params"])
    plain = InferenceModel(device="cpu").load_zoo(m)
    im = InferenceModel(device="cpu").load_zoo(m)
    im.shard("tp2", param_rules=RULES)
    xb = np.asarray(case["x"], np.float32)

    def body():
        info = im.shard_info()
        got = im.predict(xb)
        want = plain.predict(xb)
        im.set_ladder(compile_ahead.BucketLadder(2, 8))
        im.warm_up(sample_input=np.zeros((1, 16), np.float32), block=True)
        base = _misses()
        rng = np.random.RandomState(2)
        shapes = [list(im.predict(rng.randn(n, 16).astype(
            np.float32)).shape) for n in (2, 3, 4, 5, 8)]
        return {"info": info, "pred": got.tolist(),
                "plain": want.tolist(), "shapes": shapes,
                "new_misses": _misses() - base}
    out = _lead(im, body)
    out["sharded_after"] = im.shard_info() is not None
    return out


def _bert(case):
    from analytics_zoo_tpu_torch.text import BertConfig, init_bert_weights
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    return init_bert_weights(
        _ClassifierModule(BertConfig(**case["config"]), 2), 0)


def bert_tp(case):
    """BERT under "tp2" with ``bert_tp_rules`` (the attention on half the
    heads a rank): the sharded predict against the one-rank one."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.text.bert import bert_tp_rules
    module = _bert(case)
    ids = np.asarray(case["ids"], np.int32)
    plain = InferenceModel(device="cpu").load_torch(module, ids[:1])
    im = InferenceModel(device="cpu").load_torch(module, ids[:1])
    im.shard("tp2", param_rules=bert_tp_rules())
    local = {n: list(p.shape) for n, p in
             im._sharded.module.named_parameters()
             if n.endswith("query.weight")}

    def body():
        got = im.predict(ids)
        want = plain.predict(ids)
        return {"err": float(np.abs(np.asarray(got)
                                    - np.asarray(want)).max()),
                "info": im.shard_info(), "gathered": im._sharded.gathered}
    out = _lead(im, body)
    out["query"] = local
    return out


def ncf_tp(case):
    """NeuralCF under "tp2" with its tensor-parallel rules (the tables
    split by columns, the lookup on each rank's block)."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    torch.manual_seed(0)
    ncf = NeuralCF(**case["ncf"])
    x = np.asarray(case["x"], np.int32)
    plain = InferenceModel(device="cpu").load_zoo(ncf)
    im = InferenceModel(device="cpu").load_zoo(ncf)
    im.shard("tp2", param_rules=NeuralCF.tp_param_rules())
    tables = {n: list(p.shape) for n, p in
              im._sharded.module.named_parameters()
              if n in im._sharded.shards}

    def body():
        got = im.predict(x)
        return {"err": float(np.abs(np.asarray(got)
                                    - np.asarray(plain.predict(x))).max()),
                "covered": sorted(set(im._sharded.shards)
                                  - set(im._sharded.gathered))}
    out = _lead(im, body)
    out["tables"] = tables
    return out


def generate(case):
    """JAX ``test_serving_generate_end_to_end`` on a Seq2Seq sharded
    "tp2": a generate record through ClusterServing and the FrontEnd
    (prefill and every decode step through the followers), against
    ``generate(mode="raw")``; a plain record beside it; the decode spans
    on /trace and the sharding block on /healthz."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import Seq2Seq
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 FrontEnd, InputQueue,
                                                 OutputQueue)
    steps = case["steps"]
    torch.manual_seed(0)
    m = Seq2Seq(input_dim=3, output_dim=2, hidden_size=8, rnn_type="gru",
                encoder_seq_len=5, decoder_seq_len=4)
    im = InferenceModel(device="cpu").load_zoo(m)
    im.shard("tp2")
    rng = np.random.RandomState(0)
    enc = rng.randn(5, 3).astype(np.float32)
    start = np.zeros(2, np.float32)

    def body():
        b = Broker.launch(backend="python")
        eng = ClusterServing(im, b.port, batch_size=4, warmup=False)
        eng.start()
        fe = FrontEnd(b.port, engine=eng).start()
        try:
            in_q = InputQueue(port=b.port)
            out_q = OutputQueue(port=b.port)
            uri = in_q.enqueue("e2e_gen", generate={
                "max_new_tokens": steps, "mode": "raw"}, x=enc, start=start)
            res = out_q.query(uri, timeout=90.0)
            ref = im.generate(enc[None], start[None], steps, mode="raw")
            uri2 = in_q.enqueue("e2e_plain", a_enc=enc,
                                b_dec=np.zeros((4, 2), np.float32))
            res2 = out_q.query(uri2, timeout=60.0)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{fe.port}/trace?uri=e2e_gen") as r:
                tr = json.loads(r.read())
            names = [str(e.get("name", "")) for e in
                     tr.get("traceEvents", [])]
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{fe.port}/healthz") as r:
                    hz = json.loads(r.read())
            except urllib.error.HTTPError as e:
                hz = json.loads(e.read())
            metrics = eng.metrics()
        finally:
            fe.stop()
            eng.stop()
            b.stop()
        return {"res": None if res is None else np.asarray(res).tolist(),
                "ref": np.asarray(ref)[0].tolist(),
                "plain_shape": None if res2 is None
                else list(np.asarray(res2).shape),
                "spans": sum(1 for n in names
                             if n.startswith("decode_step_")),
                "sharding": hz.get("sharding"),
                "metrics_sharding": metrics.get("sharding")}
    return _lead(im, body)
