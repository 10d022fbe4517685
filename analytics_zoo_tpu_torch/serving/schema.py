"""Serving wire format — how tensors travel through the data plane.

The port's own copy of ``analytics_zoo_tpu/serving/schema.py``, trimmed
to what this slice uses. A record is one JSON object — ``{"uri",
"inputs": {name: tensor}}`` — where each tensor carries dtype/shape plus
b64 raw bytes (C-order), the whole record b64-wrapped for the line
protocol. Records and results are byte-compatible with the JAX package's.
Optional record encryption plugs in as an (encrypt, decrypt) byte-callable
pair. A generate request rides the record's side channel as the JAX
client writes it (``{"trace": {"g": {"n", "m", "t", "s"}}}``). Images,
priority lanes, deadlines and the Arrow format wait for later slices.
"""

from __future__ import annotations

import base64
import json
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

Cipher = Optional[Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]]

# uris become fields of the space/newline-delimited broker protocol: a
# permissive uri would corrupt the framing (or inject commands), so the
# charset is locked down at the schema boundary.
_URI_RE = re.compile(r"^[A-Za-z0-9._:-]{1,256}$")


class ServingError(RuntimeError):
    """An error result stored in place of a prediction."""


#: generation feedback modes a generate record may request (mirrors
#: inference/generation.MODES, kept here so the wire schema needs no torch)
GENERATE_MODES = ("raw", "greedy", "sample")


def validate_generate(generate) -> Optional[Dict[str, Any]]:
    """Normalize a client ``generate`` request into the compact wire form
    carried on the record's side channel (the ``"g"`` key): ``{"n":
    steps[, "m": mode, "t": temperature, "s": seed]}``, defaults (greedy,
    temperature 1.0, no seed) omitted. Accepts the long keys
    ``max_new_tokens``/``mode``/``temperature``/``seed`` or the wire keys;
    ``None`` passes through (not a generate record)."""
    if generate is None:
        return None
    if not isinstance(generate, dict):
        raise ValueError("generate must be a dict of decode options")
    g = dict(generate)
    n = g.pop("max_new_tokens", g.pop("n", 16))
    mode = g.pop("mode", g.pop("m", "greedy"))
    temperature = g.pop("temperature", g.pop("t", 1.0))
    seed = g.pop("seed", g.pop("s", None))
    if g:
        raise ValueError(f"unknown generate keys: {sorted(g)}")
    n = int(n)
    if n < 1:
        raise ValueError(f"generate max_new_tokens must be >= 1, got {n}")
    if mode not in GENERATE_MODES:
        raise ValueError(
            f"bad generate mode {mode!r}: one of {GENERATE_MODES}")
    out: Dict[str, Any] = {"n": n}
    if mode != "greedy":
        out["m"] = str(mode)
    if float(temperature) != 1.0:
        out["t"] = float(temperature)
    if seed is not None:
        out["s"] = int(seed)
    return out


def validate_uri(uri: str) -> str:
    if not _URI_RE.match(uri or ""):
        raise ValueError(
            f"bad uri {uri!r}: use 1-256 chars of [A-Za-z0-9._:-]")
    return uri


def encode_tensor(arr) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode()}


def decode_tensor(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj["data"])
    return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
        obj["shape"]).copy()


def _wrap(obj: dict, cipher: Cipher) -> str:
    body = json.dumps(obj).encode()
    if cipher is not None:
        body = cipher[0](body)
    return base64.b64encode(body).decode()


def _unwrap(payload_b64: str, cipher: Cipher) -> dict:
    body = base64.b64decode(payload_b64)
    if cipher is not None:
        body = cipher[1](body)
    return json.loads(body)


def encode_record(uri: str, inputs: Dict[str, np.ndarray],
                  cipher: Cipher = None,
                  generate: Optional[Dict[str, Any]] = None) -> str:
    """``generate``: a request in wire form (``validate_generate``),
    written where the JAX client writes it."""
    obj: Dict[str, Any] = {"uri": uri,
                           "inputs": {k: encode_tensor(np.asarray(v))
                                      for k, v in inputs.items()}}
    if generate is not None:
        obj["trace"] = {"g": generate}
    return _wrap(obj, cipher)


def decode_record(payload_b64: str, cipher: Cipher = None,
                  with_generate: bool = False):
    """(uri, inputs), or with ``with_generate`` (uri, inputs, g) where
    ``g`` is the record's generate request as it came (None for a plain
    record). The JAX client's other trace fields are ignored."""
    obj = _unwrap(payload_b64, cipher)
    inputs = {k: decode_tensor(v) for k, v in obj["inputs"].items()}
    if not with_generate:
        return obj["uri"], inputs
    meta = obj.get("trace")
    g = meta.get("g") if isinstance(meta, dict) else None
    return obj["uri"], inputs, g


def encode_result(arr: np.ndarray, cipher: Cipher = None) -> str:
    return _wrap(encode_tensor(np.asarray(arr)), cipher)


def encode_error(message: str, cipher: Cipher = None) -> str:
    return _wrap({"error": str(message)[:2000]}, cipher)


def decode_result(payload_b64: str, cipher: Cipher = None) -> np.ndarray:
    obj = _unwrap(payload_b64, cipher)
    if "error" in obj:
        raise ServingError(obj["error"])
    return decode_tensor(obj)
