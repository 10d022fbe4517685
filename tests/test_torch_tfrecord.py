"""The port's TFRecord / tf.Example reader and writer against the JAX
package's, on the CPU.

Held bitwise: for the same records both packages write the same bytes,
each package parses the other's files into the same feature dicts
(values and dtypes), and the shards split alike. Truncated and corrupt
input raise ``IOError`` in both; the header's CRC is checked before its
length is trusted. A read feeds the port's NCF ``fit`` with the same
losses as the same fit from the arrays in memory. JAX is imported by
fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.data import tfrecord as ttf


@pytest.fixture(scope="module")
def jtf():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.data import tfrecord
    return tfrecord


def _records(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [{
        "image": rng.rand(12).astype(np.float32),
        "label": np.asarray([i % 3], np.int64),
        "ids": rng.randint(-2 ** 40, 2 ** 40, 3).astype(np.int64),
        "flag": np.asarray([i % 2 == 0]),
        "name": f"rec{i}".encode(),
        "tags": ["a", f"t{i}"],
    } for i in range(n)]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_encoding_is_jax_byte_for_byte(jtf):
    for rec in _records(5):
        assert ttf.encode_example(rec) == jtf.encode_example(rec)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_reads_the_others_files(jtf, tmp_path, writer):
    recs = _records()
    p = str(tmp_path / "data.tfrecord")
    (ttf if writer == "port" else jtf).write_tfrecords(p, recs)
    for reader in (ttf, jtf):
        back = reader.read_tfrecords(p)
        assert len(back) == len(recs)
        for g, w in zip(back, jtf.read_tfrecords(p)):
            _same(g, w)
    q = str(tmp_path / "other.tfrecord")
    (jtf if writer == "port" else ttf).write_tfrecords(q, recs)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_directory_glob_and_shards_as_jax(jtf, tmp_path):
    ttf.write_tfrecords(str(tmp_path / "a.tfrecord"), _records(3, 1))
    ttf.write_tfrecords(str(tmp_path / "b.tfr"), _records(4, 2))
    ttf.write_tfrecords(str(tmp_path / "c.tfrecord-00001"), _records(2, 3))
    (tmp_path / "skip.txt").write_text("not a record")
    got = ttf.read_tfrecords_as_shards(str(tmp_path), num_shards=3)
    want = jtf.read_tfrecords_as_shards(str(tmp_path), num_shards=3)
    gc, wc = got.collect(), want.collect()
    assert [len(s) for s in gc] == [len(s) for s in wc] == [3, 3, 3]
    for gs, ws in zip(gc, wc):
        for g, w in zip(gs, ws):
            _same(g, w)


def test_negative_and_bool_ints_as_jax(jtf):
    rec = {"v": np.asarray([-5, 3], np.int64),
           "b": np.asarray([True, False])}
    _same(ttf.parse_example(ttf.encode_example(rec)),
          jtf.parse_example(jtf.encode_example(rec)))
    assert ttf.parse_example(ttf.encode_example(rec))["v"].tolist() == \
        [-5, 3]


@pytest.mark.parametrize("damage", ["payload_crc", "header_crc",
                                    "truncated", "short_header"])
def test_damaged_files_raise_ioerror_in_both(jtf, tmp_path, damage):
    p = str(tmp_path / "x.tfrecord")
    ttf.write_tfrecords(p, _records(2))
    raw = bytearray(open(p, "rb").read())
    if damage == "payload_crc":
        raw[-1] ^= 0xFF
    elif damage == "header_crc":
        raw[8] ^= 0xFF
    elif damage == "truncated":
        raw = raw[:-6]
    else:
        raw = raw + b"\x01\x02\x03"
    open(p, "wb").write(bytes(raw))
    for pkg in (ttf, jtf):
        with pytest.raises(IOError):
            pkg.read_tfrecords(p)
    if damage == "payload_crc":
        assert len(ttf.read_tfrecords(p, verify_crc=False)) == 2


def test_a_corrupt_length_is_not_trusted(tmp_path):
    """A length field flipped to petabytes fails on the header's CRC
    before any read of that length."""
    p = str(tmp_path / "x.tfrecord")
    ttf.write_tfrecords(p, _records(1))
    raw = bytearray(open(p, "rb").read())
    raw[6] = 0x7F
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="header"):
        ttf.read_tfrecords(p)


def test_tfrecords_feed_an_ncf_fit_as_the_arrays_do(tmp_path):
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import NeuralCF
    rng = np.random.RandomState(0)
    n = 256
    users = rng.randint(1, 51, n)
    items = rng.randint(1, 41, n)
    labels = rng.randint(0, 5, n)
    recs = [{"pair": np.asarray([u, i], np.int64),
             "label": np.asarray([y], np.int64)}
            for u, i, y in zip(users, items, labels)]
    for k in range(4):
        ttf.write_tfrecords(str(tmp_path / f"part-{k}.tfrecord"),
                            recs[k * 64:(k + 1) * 64])
    shards = ttf.read_tfrecords_as_shards(str(tmp_path), num_shards=2)
    back = [r for s in shards.collect() for r in s]
    x = np.stack([r["pair"] for r in back]).astype(np.int32)
    y = np.asarray([r["label"][0] for r in back], np.int32)

    def fit(xx, yy):
        m = NeuralCF(user_count=50, item_count=40, class_num=5,
                     user_embed=8, item_embed=8, hidden_layers=(16, 8),
                     include_mf=True, mf_embed=8)
        m.compile(optimizer=Adam(1e-3),
                  loss="sparse_categorical_crossentropy", device="cpu")
        m.fit(xx, yy, batch_size=64, nb_epoch=2, shuffle=False)
        return np.asarray(m.model.estimator.step_losses)

    want = fit(np.stack([users, items], 1).astype(np.int32),
               labels.astype(np.int32))
    np.testing.assert_array_equal(fit(x, y), want)
