"""Write small checkpoints with the JAX package, for the port to read.

    python3 dev/make_jax_checkpoints.py [--out tests/data/jax_checkpoints]

Runs the JAX package on the CPU and writes, through ``ZooModel.save_model``
(``config.json`` + ``weights/ckpt-0/``), the small models of the port's
tests:

- ``ncf/``: ``NeuralCF`` (users 50, items 40, widths 8, hidden (16, 8),
  5 classes, GMF), compiled with ``Adam(1e-2)``; ``ncf_x.npy`` holds 64
  (user, item) rows and ``ncf_pred.npy`` the JAX package's predictions;
- ``seq2seq/``: a GRU ``Seq2Seq`` (dims 4, hidden 16, encoder length 5);
  ``seq2seq_enc.npy`` / ``seq2seq_dec.npy`` an input pair with
  ``seq2seq_pred.npy`` its prediction, and ``seq2seq_start.npy`` a start
  token with ``seq2seq_greedy.npy`` its 10 greedy steps (each step's top
  two scores apart by more than 1e-4, so the tokens are robust to
  rounding);
- ``wide_and_deep/``: a ``wide_n_deep`` ``WideAndDeep`` (wide base (10,
  10), cross (20,), indicator (4,), embed in (30, 40) out (8, 16), 1
  continuous, hidden (16, 8), 2 classes), compiled with ``Adam(1e-2)``;
  ``wide_and_deep_{wide,indicator,embed,continuous}.npy`` hold 64 rows of
  its four inputs and ``wide_and_deep_pred.npy`` the JAX package's
  predictions;
- ``tcn/``: a Zouwu ``TCNForecaster`` (future 2, channels (8, 8), kernel
  3, Adam) as ``Forecaster.save`` writes it (``ckpt-0/``); ``tcn_x.npy``
  holds 32 windows of 16 steps and 3 features and ``tcn_pred.npy`` the
  JAX package's forecasts.

The weights are flax's initial values from the models' seeds: the files
do not depend on how many devices JAX sees. ``tests/test_torch_checkpoint
.py`` checks that the committed files are what this script writes
(``meta.json``'s time aside) and that the port, which has no JAX, reads
them and predicts the same; ``chip_smoke.py`` reads them on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "jax_checkpoints")

NCF_ARGS = dict(user_count=50, item_count=40, class_num=5, user_embed=8,
                item_embed=8, hidden_layers=(16, 8), include_mf=True,
                mf_embed=8)
SEQ2SEQ_ARGS = dict(input_dim=4, output_dim=4, hidden_size=16,
                    rnn_type="gru", num_layers=1, encoder_seq_len=5,
                    decoder_seq_len=4)
GREEDY_STEPS = 10
WND_COLUMNS = dict(
    wide_base_cols=["a", "b"], wide_base_dims=[10, 10],
    wide_cross_cols=["ab"], wide_cross_dims=[20],
    indicator_cols=["c"], indicator_dims=[4],
    embed_cols=["u", "i"], embed_in_dims=[30, 40], embed_out_dims=[8, 16],
    continuous_cols=["age"])
WND_ARGS = dict(class_num=2, model_type="wide_n_deep", hidden_layers=(16, 8))
WND_INPUTS = ("wide", "indicator", "embed", "continuous")
TCN_ARGS = dict(future_seq_len=2, num_channels=(8, 8), kernel_size=3)


def ncf_inputs() -> np.ndarray:
    rng = np.random.RandomState(7)
    return np.stack([rng.randint(1, 51, 64), rng.randint(1, 41, 64)],
                    1).astype(np.float32)


def seq2seq_inputs():
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, 5, 4)).astype(np.float32)
    dec = rng.normal(size=(2, 4, 4)).astype(np.float32)
    start = np.zeros((2, 4), np.float32)
    start[:, 0] = 1.0
    return enc, dec, start


def wide_and_deep_inputs():
    """64 rows of the four inputs: one-hot wide and indicator blocks, ids
    in ``[0, in_dim]``, normal continuous values."""
    rng = np.random.default_rng(5)
    n = 64
    wide = np.zeros((n, 40), np.float32)
    wide[np.arange(n), rng.integers(0, 40, n)] = 1.0
    ind = np.zeros((n, 4), np.float32)
    ind[np.arange(n), rng.integers(0, 4, n)] = 1.0
    emb = np.stack([rng.integers(0, 31, n), rng.integers(0, 41, n)],
                   1).astype(np.float32)
    con = rng.normal(size=(n, 1)).astype(np.float32)
    return wide, ind, emb, con


def tcn_inputs() -> np.ndarray:
    return np.random.default_rng(9).normal(size=(32, 16, 3)).astype(
        np.float32)


def write_all(out: str) -> None:
    """Write the four models and their arrays under ``out`` (replaced)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.inference import InferenceModel
    from analytics_zoo_tpu.inference import generation
    from analytics_zoo_tpu.learn.optimizers import Adam
    from analytics_zoo_tpu.models import Seq2Seq
    from analytics_zoo_tpu.models.recommendation import (ColumnFeatureInfo,
                                                         NeuralCF,
                                                         WideAndDeep)
    from analytics_zoo_tpu.zouwu.model.forecast import TCNForecaster

    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)

    ncf = NeuralCF(**NCF_ARGS)
    ncf.compile(optimizer=Adam(1e-2),
                loss="sparse_categorical_crossentropy")
    ncf.save_model(os.path.join(out, "ncf"))
    x = ncf_inputs()
    np.save(os.path.join(out, "ncf_x.npy"), x)
    np.save(os.path.join(out, "ncf_pred.npy"), np.asarray(ncf.predict(x)))

    s2s = Seq2Seq(**SEQ2SEQ_ARGS)
    s2s.save_model(os.path.join(out, "seq2seq"))
    enc, dec, start = seq2seq_inputs()
    im = InferenceModel().load_zoo(s2s)
    np.save(os.path.join(out, "seq2seq_enc.npy"), enc)
    np.save(os.path.join(out, "seq2seq_dec.npy"), dec)
    np.save(os.path.join(out, "seq2seq_pred.npy"),
            np.asarray(im.predict((enc, dec))))
    margins = []
    step = im.decode_step_fn()

    def watched(e, d):
        scores = np.asarray(step(e, d))
        top = np.sort(scores[:, len(margins), :], axis=-1)
        margins.append(float((top[:, -1] - top[:, -2]).min()))
        return scores

    greedy = generation.decode_loop(watched, enc, start, GREEDY_STEPS,
                                    ladder=None, mode="greedy")
    if min(margins) <= 1e-4:
        raise RuntimeError(f"greedy margins too small to pin: {margins}")
    np.save(os.path.join(out, "seq2seq_start.npy"), start)
    np.save(os.path.join(out, "seq2seq_greedy.npy"), np.asarray(greedy))

    wnd = WideAndDeep(column_info=ColumnFeatureInfo(**WND_COLUMNS),
                      **WND_ARGS)
    wnd.compile(optimizer=Adam(1e-2),
                loss="sparse_categorical_crossentropy")
    wnd.save_model(os.path.join(out, "wide_and_deep"))
    xs = wide_and_deep_inputs()
    for name, arr in zip(WND_INPUTS, xs):
        np.save(os.path.join(out, f"wide_and_deep_{name}.npy"), arr)
    np.save(os.path.join(out, "wide_and_deep_pred.npy"),
            np.asarray(wnd.predict(list(xs))))

    tcn = TCNForecaster(**TCN_ARGS)
    x = tcn_inputs()
    tcn._ensure_est(x)
    tcn.save(os.path.join(out, "tcn"))
    np.save(os.path.join(out, "tcn_x.npy"), x)
    np.save(os.path.join(out, "tcn_pred.npy"), tcn.predict(x))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    write_all(args.out)
    sizes = {}
    for d, _, files in os.walk(args.out):
        for f in files:
            p = os.path.join(d, f)
            sizes[os.path.relpath(p, args.out)] = os.path.getsize(p)
    print(json.dumps({"out": args.out, "bytes": sum(sizes.values()),
                      "files": sizes}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
