"""Arrow and encrypted records in the port against the JAX package's, on
the CPU.

- ``common/encryption``: AES-GCM and AES-CBC in both directions between
  the packages (the port decrypts what JAX encrypts and JAX what the
  port encrypts), for the byte and the base64 string forms and for
  ``make_cipher``'s pairs; on a host without ``cryptography`` every
  entry point raises ``ImportError`` naming it.
- ``serving/schema``: an Arrow record (the reference client's format)
  written by JAX's ``encode_record_arrow`` decodes in the port to JAX's
  decoded inputs (dense, sparse, string and image columns), and the
  port's encoding decodes in JAX alike.
- ``ClusterServing`` on the CPU answers an Arrow record and an encrypted
  record written by JAX's client, and the port's own
  ``InputQueue(arrow=True)`` / ``cipher=`` records, each equal to the
  model's direct predict (an encrypted result decrypts in either
  package).

JAX is imported by fixtures only.
"""

import base64
import json
import sys

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import encryption as tenc
from analytics_zoo_tpu_torch.common import slo, telemetry
from analytics_zoo_tpu_torch.serving import schema as tschema

SECRET = "analytics-zoo"


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset_for_tests()
    slo.set_monitor(None)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.common import encryption as jenc
    from analytics_zoo_tpu.serving import client as jclient
    from analytics_zoo_tpu.serving import schema as jschema
    return dict(enc=jenc, schema=jschema, client=jclient)


@pytest.mark.parametrize("mode", ["gcm", "cbc"])
def test_encryption_crosses_the_packages(jx, mode):
    jenc = jx["enc"]
    data = bytes(range(256)) * 3 + b"tail"
    for enc, dec in ((getattr(tenc, f"encrypt_bytes_with_aes_{mode}"),
                      getattr(jenc, f"decrypt_bytes_with_aes_{mode}")),
                     (getattr(jenc, f"encrypt_bytes_with_aes_{mode}"),
                      getattr(tenc, f"decrypt_bytes_with_aes_{mode}"))):
        assert dec(enc(data, SECRET), SECRET) == data
    for enc, dec in ((getattr(tenc, f"encrypt_with_aes_{mode}"),
                      getattr(jenc, f"decrypt_with_aes_{mode}")),
                     (getattr(jenc, f"encrypt_with_aes_{mode}"),
                      getattr(tenc, f"decrypt_with_aes_{mode}"))):
        assert dec(enc("plain text", SECRET), SECRET) == "plain text"
    t_e, t_d = tenc.make_cipher(SECRET, mode)
    j_e, j_d = jenc.make_cipher(SECRET, mode)
    assert j_d(t_e(data)) == data and t_d(j_e(data)) == data
    # the same salt and key derivation give JAX's ciphertext layout
    salt = b"\x01" * tenc.SALT_LEN
    blob = tenc.encrypt_bytes_with_aes_gcm(b"x", SECRET, salt=salt)
    assert blob[:tenc.SALT_LEN] == salt
    assert len(blob) == tenc.SALT_LEN + tenc.NONCE_LEN + 1 + 16
    # tampered: GCM's tag fails; under CBC the last block's pad byte
    # (16 - len % 16) becomes 0, which no padding has (a random byte would
    # pass the padding check now and then)
    blob = bytearray(t_e(data))
    blob[-17] ^= 16 - len(data) % 16
    with pytest.raises(Exception):
        t_d(bytes(blob))


def test_without_cryptography_every_entry_names_it(monkeypatch, tmp_path):
    for mod in [m for m in sys.modules if m.startswith("cryptography")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    for call in (lambda: tenc.make_cipher(SECRET),
                 lambda: tenc.encrypt_bytes_with_aes_cbc(b"x", SECRET),
                 lambda: tenc.decrypt_with_aes_gcm("AAAA", SECRET)):
        with pytest.raises(ImportError, match="cryptography"):
            call()
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    p = tmp_path / "c.yaml"
    p.write_text("model:\n  path: m\ndata:\n  record_encrypted: true\n")
    with pytest.raises(ImportError, match="cryptography"):
        ServingConfig.load(str(p)).build_cipher(SECRET)


def _arrow_inputs():
    rng = np.random.RandomState(0)
    png = base64.b64decode(
        "iVBORw0KGgoAAAANSUhEUgAAAAEAAAABCAYAAAAfFcSJAAAADUlEQVR42mNk+M9Q"
        "DwADhgGAWjR9awAAAABJRU5ErkJggg==")
    return {"x": rng.randn(2, 3).astype(np.float32),
            "words": np.asarray(["a", "bb", "ccc"]),
            "img": tschema.ImageBytes(png)}


def _same_inputs(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if hasattr(v, "data") and not isinstance(v, np.ndarray):
            assert type(got[k]).__name__ == "ImageBytes"
            assert got[k].data == v.data
        else:
            np.testing.assert_array_equal(got[k], v)


def test_arrow_records_cross_the_packages(jx):
    js = jx["schema"]
    inputs = _arrow_inputs()
    jin = dict(inputs, img=js.ImageBytes(inputs["img"].data))
    payload = js.encode_record_arrow("u1", jin)
    uri, got, meta = tschema.decode_record_meta(payload)
    assert uri == "u1" and meta == {}
    _same_inputs(got, js.decode_record_meta(payload)[1])
    back = tschema.encode_record_arrow("u2", inputs)
    assert back == js.encode_record_arrow("u2", jin)
    _same_inputs(js.decode_record_meta(back)[1], got)
    # a sparse tensor (indices, values, dense shape), as the reference
    # client writes one
    import pyarrow as pa
    t = pa.struct([pa.field("indiceData", pa.list_(pa.int32())),
                   pa.field("indiceShape", pa.list_(pa.int32())),
                   pa.field("data", pa.list_(pa.float32())),
                   pa.field("shape", pa.list_(pa.int32()))])
    col = pa.array([{"indiceData": [0, 1, 2, 0]}, {"indiceShape": [2, 2]},
                    {"data": [5.0, 7.0]}, {"shape": [3, 2]}], type=t)
    sink = pa.BufferOutputStream()
    batch = pa.RecordBatch.from_arrays([col], names=["s"])
    with pa.RecordBatchStreamWriter(sink, batch.schema) as w:
        w.write_batch(batch)
    b64 = base64.b64encode(sink.getvalue().to_pybytes()).decode()
    want = np.zeros((3, 2), np.float32)
    want[0, 1], want[2, 0] = 5.0, 7.0
    np.testing.assert_array_equal(tschema.decode_arrow_inputs(b64)["s"],
                                  want)
    np.testing.assert_array_equal(js.decode_arrow_inputs(b64)["s"], want)


class _Doubler:
    """A model the engine can batch: rows times 2 plus their sum."""

    def predict(self, x):
        x = np.asarray(x, np.float32)
        return x * 2.0 + x.sum(-1, keepdims=True)


def test_engine_answers_arrow_and_encrypted_records(jx):
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)
    jc = jx["client"]
    rng = np.random.RandomState(4)
    rows = rng.randn(6, 3).astype(np.float32)
    want = _Doubler().predict(rows)
    t_cipher = tenc.make_cipher(SECRET)
    j_cipher = jx["enc"].make_cipher(SECRET)
    with Broker.launch(backend="python") as b:
        # Arrow records: JAX's client and the port's, no cipher
        with ClusterServing(_Doubler(), b.port, batch_size=2,
                            max_batch_size=2, warmup=False):
            jq = jc.InputQueue(port=b.port, arrow=True)
            tq = InputQueue(port=b.port, arrow=True)
            oq = OutputQueue(port=b.port)
            uris = [jq.enqueue(f"ja{i}", x=rows[i]) for i in range(3)]
            uris += [tq.enqueue(f"ta{i}", x=rows[3 + i]) for i in range(3)]
            for i, uri in enumerate(uris):
                np.testing.assert_array_equal(oq.query(uri, timeout=30.0),
                                              want[i])
            with pytest.raises(ValueError, match="side channel"):
                tq.enqueue("d", deadline_ms=10.0, x=rows[0])
            for q in (jq, tq, oq):
                q.close()
        # encrypted records: JAX's client (JAX's cipher) and the port's
        with ClusterServing(_Doubler(), b.port, batch_size=2,
                            max_batch_size=2, warmup=False,
                            cipher=t_cipher):
            jq = jc.InputQueue(port=b.port, cipher=j_cipher)
            tq = InputQueue(port=b.port, cipher=t_cipher)
            uris = [jq.enqueue(f"je{i}", x=rows[i]) for i in range(3)]
            uris += [tq.enqueue(f"te{i}", x=rows[3 + i]) for i in range(3)]
            toq = OutputQueue(port=b.port, cipher=t_cipher)
            joq = jc.OutputQueue(port=b.port, cipher=j_cipher)
            for i, uri in enumerate(uris):
                q = toq if i % 2 else joq
                np.testing.assert_array_equal(q.query(uri, timeout=30.0),
                                              want[i])
            # the stored result is ciphertext: no plain JSON in the hash
            raw = b.client().hget("result", uris[0])
            with pytest.raises(Exception):
                json.loads(base64.b64decode(raw))
            for q in (jq, tq, toq, joq):
                q.close()
