"""The port's image-parquet dataset (``data/image``) against the JAX
package's, on the CPU.

Held bitwise: what either package writes (scalar, ndarray and image
fields; ``write_ndarrays``, ``write_from_directory`` with its shuffle,
``write_mnist``) the other reads into the same shards, the files and
the schema are the same bytes, ``read_as_dataset`` gives the batches
JAX's gives, and the row iterators yield the same rows. The errors keep
their types (``FileExistsError``, ``ValueError`` for a bad MNIST magic,
``FileNotFoundError`` for no chunks); a host without pyarrow or PIL gets
an ``ImportError`` naming the package. JAX is imported by fixtures only.
"""

import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("pyarrow")
PILImage = pytest.importorskip("PIL.Image")

from analytics_zoo_tpu_torch.data import image as tim  # noqa: E402
from analytics_zoo_tpu_torch.data.image import parquet_dataset as tpd  # noqa: E402,E501


@pytest.fixture(scope="module")
def jim():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.data import image
    return image


def _pkg(name, jim):
    return tim if name == "port" else jim


def _same_shards(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            if x[k].dtype == object:
                assert [bytes(v) for v in x[k]] == [bytes(v) for v in y[k]]
            else:
                np.testing.assert_array_equal(x[k], y[k])


def _images(tmp_path, n=8):
    root = tmp_path / "imgs"
    rng = np.random.RandomState(0)
    for i in range(n):
        cls = "cat" if i % 2 == 0 else "dog"
        os.makedirs(root / cls, exist_ok=True)
        PILImage.fromarray(rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)
                           ).save(root / cls / f"{i}.png")
    return str(root)


def _files(path):
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, path)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_every_field_kind_reads_back_in_both(tmp_path, jim, writer):
    img = str(tmp_path / "one.png")
    PILImage.fromarray(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
                       ).save(img)
    pkg = _pkg(writer, jim)
    schema = {"id": pkg.Scalar("int64"), "feat": pkg.NDarray("float32"),
              "img": pkg.Image()}
    feats = np.random.RandomState(1).rand(5, 3).astype(np.float32)

    def gen():
        for i in range(5):
            yield {"id": i, "feat": feats[i], "img": img}

    out = str(tmp_path / "pq")
    pkg.ParquetDataset.write(out, gen(), schema, block_size=2)
    for decode in (True, False):
        got = tim.ParquetDataset.read_as_xshards(out, decode).collect()
        want = jim.ParquetDataset.read_as_xshards(out, decode).collect()
        assert len(got) == 3                              # 2 + 2 + 1
        _same_shards(got, want)


def test_files_and_schema_are_jax_byte_for_byte(tmp_path, jim):
    x = np.random.RandomState(2).randint(0, 256, (10, 28, 28)).astype(
        np.uint8)
    y = np.arange(10, dtype=np.int64)
    tim.write_ndarrays(x, y, str(tmp_path / "t"), block_size=4)
    jim.write_ndarrays(x, y, str(tmp_path / "j"), block_size=4)
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))


def test_write_from_directory_shuffles_as_jax(tmp_path, jim):
    src = _images(tmp_path)
    for name in ("port", "jax"):
        _pkg(name, jim).write_from_directory(
            src, {"cat": 0, "dog": 1}, str(tmp_path / name), block_size=3)
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    _same_shards(
        tim.ParquetDataset.read_as_xshards(str(tmp_path / "jax")).collect(),
        jim.ParquetDataset.read_as_xshards(str(tmp_path / "port")).collect())


def test_read_as_dataset_batches_as_jax_and_feeds_a_fit(tmp_path, jim):
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as kl
    out = str(tmp_path / "pq")
    tim.write_from_directory(_images(tmp_path), {"cat": 0, "dog": 1}, out,
                             block_size=4)
    got = tim.ParquetDataset.read_as_dataset(out, "image", "label")
    want = jim.ParquetDataset.read_as_dataset(out, "image", "label")
    assert got.n == want.n == 8
    for (gx, gy, gm), (wx, wy, wm) in zip(got.iter_batches(batch_size=4),
                                          want.iter_batches(batch_size=4)):
        np.testing.assert_array_equal(np.asarray(gx), np.asarray(wx))
        np.testing.assert_array_equal(np.asarray(gy), np.asarray(wy))
        np.testing.assert_array_equal(np.asarray(gm), np.asarray(wm))
    m = Sequential()
    m.add(kl.Flatten(input_shape=(8, 8, 3)))
    m.add(kl.Dense(2))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy_logits",
              device="cpu")
    h = m.estimator.fit(got, epochs=1, batch_size=8)
    assert np.isfinite(h["loss"][0])


def test_row_iterators_and_mnist_as_jax(tmp_path, jim):
    out = str(tmp_path / "rows")
    tim.write_ndarrays(np.arange(12, dtype=np.float32).reshape(6, 2),
                       np.arange(6, dtype=np.int64), out, block_size=4)
    for read in ("read_as_torch", "read_as_tf"):
        got = list(getattr(tim.ParquetDataset, read)(out)())
        want = list(getattr(jim.ParquetDataset, read)(out)())
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    n, r, c = 4, 3, 3
    images = np.arange(n * r * c, dtype=np.uint8).reshape(n, r, c)
    img_f, lbl_f = str(tmp_path / "img"), str(tmp_path / "lbl")
    with open(img_f, "wb") as f:
        for v in (2051, n, r, c):
            f.write(int(v).to_bytes(4, "big"))
        f.write(images.tobytes())
    with open(lbl_f, "wb") as f:
        for v in (2049, n):
            f.write(int(v).to_bytes(4, "big"))
        f.write(np.arange(n, dtype=np.uint8).tobytes())
    tim.write_mnist(img_f, lbl_f, str(tmp_path / "m"))
    jim.write_mnist(img_f, lbl_f, str(tmp_path / "jm"))
    _same_shards(
        tim.ParquetDataset.read_as_xshards(str(tmp_path / "jm")).collect(),
        jim.ParquetDataset.read_as_xshards(str(tmp_path / "m")).collect())


@pytest.mark.parametrize("name", ["port", "jax"])
def test_errors_keep_their_types(tmp_path, jim, name):
    pkg = _pkg(name, jim)
    out = str(tmp_path / "pq")
    schema = {"id": pkg.Scalar("int64")}
    pkg.ParquetDataset.write(out, iter([{"id": 1}]), schema)
    with pytest.raises(FileExistsError):
        pkg.ParquetDataset.write(out, iter([{"id": 2}]), schema,
                                 write_mode="errorifexists")
    pkg.ParquetDataset.write(out, iter([{"id": 3}]), schema)
    assert list(pkg.ParquetDataset.read_as_xshards(out).collect()[0]["id"]) \
        == [3]
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as f:
        f.write((1234).to_bytes(4, "big"))
    with pytest.raises(ValueError, match="magic"):
        pkg.write_mnist(bad, bad, str(tmp_path / "m"))
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "_orca_metadata").write_text('{"id": {"kind": "scalar", '
                                          '"dtype": "int64"}}')
    with pytest.raises(FileNotFoundError):
        pkg.ParquetDataset.read_as_xshards(str(empty))


@pytest.mark.parametrize("missing", ["pyarrow", "PIL"])
def test_a_missing_package_is_named(tmp_path, monkeypatch, missing):
    img = str(tmp_path / "one.png")
    PILImage.fromarray(np.zeros((2, 2, 3), np.uint8)).save(img)
    out = str(tmp_path / "pq")
    tim.ParquetDataset.write(out, iter([{"img": img}]),
                             {"img": tim.Image()})
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda n, *a: None
                        if n == missing else real(n, *a))
    with pytest.raises(ImportError, match=missing):
        tim.ParquetDataset.read_as_xshards(out)
    if missing == "pyarrow":
        with pytest.raises(ImportError, match="pyarrow"):
            tim.ParquetDataset.write(out, iter([{"img": img}]),
                                     {"img": tim.Image()})
    else:                                   # undecoded reads need no PIL
        got = tpd.ParquetDataset.read_as_xshards(out, decode_images=False)
        assert got.collect()[0]["img"].dtype == object
