"""The port's ``EsTable`` against the JAX package's, on the CPU, both
talking to one in-process stub of Elasticsearch's REST API (the routes of
JAX's tests/test_elastic_search.py: ``_bulk``, ``_search`` with a scroll,
``_search/scroll``, its DELETE).

Held bitwise: the bulk bodies each package sends for the same frame,
the frames each package reads back (columns, dtypes, values, NaN), the
flattened frames and the record shards. Also: a read releases its scroll
context, writes go in chunks, a bulk error raises ``IOError`` in both.
JAX is imported by fixtures only.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from analytics_zoo_tpu_torch.data.elastic_search import EsTable  # noqa: E402


class _FakeES(BaseHTTPRequestHandler):
    store = {}          # index -> list of {"_id", "_source"}
    scrolls = {}        # scroll_id -> (index, cursor, size)
    deleted_scrolls = []
    bulk_bodies = []
    fail_bulk = False

    def log_message(self, *a):
        pass

    def _json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        return self.rfile.read(int(self.headers.get("Content-Length", 0))
                               ).decode()

    def do_DELETE(self):
        type(self).deleted_scrolls.append(json.loads(self._body())
                                          ["scroll_id"])
        self._json(200, {"succeeded": True})

    def do_POST(self):
        raw = self._body()
        cls = type(self)
        if self.path.endswith("/_bulk"):
            cls.bulk_bodies.append(raw)
            index = self.path.split("/")[1]
            lines = [ln for ln in raw.splitlines() if ln.strip()]
            docs = cls.store.setdefault(index, [])
            items = []
            for i in range(0, len(lines), 2):
                action = json.loads(lines[i])["index"]
                _id = action.get("_id", str(len(docs)))
                docs.append({"_id": _id, "_source": json.loads(lines[i + 1])})
                item = {"_id": _id, "status": 201}
                if cls.fail_bulk:
                    item["error"] = {"type": "mapper_parsing_exception"}
                items.append({"index": item})
            self._json(200, {"errors": cls.fail_bulk, "items": items})
            return
        if "/_search/scroll" in self.path:
            sid = json.loads(raw)["scroll_id"]
            index, cursor, size = cls.scrolls[sid]
            page = cls.store.get(index, [])[cursor:cursor + size]
            cls.scrolls[sid] = (index, cursor + size, size)
            self._json(200, {"_scroll_id": sid, "hits": {"hits": page}})
            return
        if "/_search" in self.path:
            index = self.path.split("/")[1]
            body = json.loads(raw or "{}")
            size = int(body.get("size", 10))
            docs = cls.store.get(index, [])
            for field, val in body.get("query", {}).get("term", {}).items():
                docs = [d for d in docs if d["_source"].get(field) == val]
            sid = f"scroll-{index}-{len(cls.scrolls)}"
            cls.scrolls[sid] = (index, size, size)
            self._json(200, {"_scroll_id": sid,
                             "hits": {"hits": docs[:size]}})
            return
        self._json(404, {"error": "unknown endpoint"})


@pytest.fixture
def es():
    _FakeES.store, _FakeES.scrolls = {}, {}
    _FakeES.deleted_scrolls, _FakeES.bulk_bodies = [], []
    _FakeES.fail_bulk = False
    server = HTTPServer(("127.0.0.1", 0), _FakeES)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield {"host": "127.0.0.1", "port": server.server_address[1]}
    server.shutdown()
    server.server_close()
    t.join(timeout=10)


@pytest.fixture(scope="module")
def jes():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.data.elastic_search import EsTable as J
    return J


def _frame(n=23, seed=0):
    rng = np.random.RandomState(seed)
    score = rng.rand(n)
    score[3] = np.nan
    return pd.DataFrame({"user": rng.randint(1, 6041, n),
                         "item": rng.randint(1, 3707, n),
                         "score": score,
                         "name": [f"u{i}" for i in range(n)]})


def _frames_equal(a, b):
    pd.testing.assert_frame_equal(a.reset_index(drop=True),
                                  b.reset_index(drop=True), check_exact=True)


def test_bulk_bodies_are_jax_byte_for_byte(es, jes):
    df = _frame()
    assert EsTable.write_df(es, "port", df, chunk_size=10) == len(df)
    port_bodies = list(_FakeES.bulk_bodies)
    _FakeES.bulk_bodies.clear()
    assert jes.write_df(es, "port", df, chunk_size=10) == len(df)
    assert _FakeES.bulk_bodies == port_bodies
    assert len(port_bodies) == 3                       # 10 + 10 + 3


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_reads_what_either_wrote(es, jes, writer):
    df = _frame()
    (EsTable if writer == "port" else jes).write_df(es, "r", df)
    got = EsTable.read_df(es, "r", batch_size=5)
    want = jes.read_df(es, "r", batch_size=5)
    assert got.num_partitions() == want.num_partitions()
    g, w = got.to_pandas(), want.to_pandas()
    _frames_equal(g, w)
    _frames_equal(g.drop(columns="_id"), df)
    assert g["user"].dtype == df["user"].dtype
    assert np.isnan(g["score"].iloc[3])


def test_scroll_context_released(es):
    EsTable.write_df(es, "r", pd.DataFrame({"x": [1, 2, 3]}))
    EsTable.read_df(es, "r", batch_size=1)
    assert len(_FakeES.deleted_scrolls) == 1


def test_query_num_shards_and_records_as_jax(es, jes):
    df = pd.DataFrame({"cls": ["a", "a", "b", "a"], "v": [1, 2, 3, 4]})
    EsTable.write_df(es, "docs", df)
    q = {"term": {"cls": "a"}}
    _frames_equal(EsTable.read_df(es, "docs", query=q).to_pandas(),
                  jes.read_df(es, "docs", query=q).to_pandas())
    got = EsTable.read_df(es, "docs", num_shards=3)
    want = jes.read_df(es, "docs", num_shards=3)
    assert got.num_partitions() == want.num_partitions() == 3
    for a, b in zip(got.collect(), want.collect()):
        _frames_equal(a, b)
    assert EsTable.read_rdd(es, "docs").collect() == \
        jes.read_rdd(es, "docs").collect()


def test_flatten_df_as_jax(jes):
    df = pd.DataFrame({"plain": [1, 2, 3],
                       "nested": [{"a": 1, "b": 2}, {"a": 3}, None],
                       "mixed": [{"k": 1}, 5, None]})
    _frames_equal(EsTable.flatten_df(df), jes.flatten_df(df))


def test_bulk_errors_raise_ioerror_in_both(es, jes):
    _FakeES.fail_bulk = True
    for pkg in (EsTable, jes):
        with pytest.raises(IOError, match="bulk index"):
            pkg.write_df(es, "bad", pd.DataFrame({"x": [1]}))
