"""Hand-written ONNX and OpenVINO IR files for the port's model-import
tests: neither the onnx nor the openvino package is installed, so tests
encode the files themselves. A copy, without JAX, of the encoders in
tests/test_onnx.py (the onnx.proto wire format) and of
tests/test_openvino.py's ``_IRBuilder`` (IR v10 xml + weight bin)."""

import os
import struct

import numpy as np


# ------------------------------------------------------------ ONNX protobuf

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # negatives: 10-byte two's complement per protobuf
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    dtype_code = {np.dtype("float32"): 1, np.dtype("int32"): 6,
                  np.dtype("int64"): 7}[arr.dtype]
    out = b""
    for d in arr.shape:
        out += _int_field(1, d)
    out += _int_field(2, dtype_code)
    out += _len_field(8, name.encode())
    out += _len_field(9, arr.tobytes())          # raw_data
    return out


def attr_int(name: str, v: int) -> bytes:
    return _len_field(1, name.encode()) + _int_field(4, v) \
        + _int_field(20, 2)                      # type = INT


def attr_ints(name: str, vals) -> bytes:
    out = _len_field(1, name.encode())
    for v in vals:
        out += _int_field(8, v)
    return out + _int_field(20, 7)               # type = INTS


def attr_float(name: str, v: float) -> bytes:
    return _len_field(1, name.encode()) + _tag(3, 5) \
        + struct.pack("<f", v) + _int_field(20, 1)


def node(op: str, inputs, outputs, attrs=()) -> bytes:
    out = b""
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    out += _len_field(4, op.encode())
    for a in attrs:
        out += _len_field(5, a)
    return out


def value_info(name: str) -> bytes:
    return _len_field(1, name.encode())


def model_proto(nodes, initializers, inputs, outputs) -> bytes:
    graph = b""
    for n in nodes:
        graph += _len_field(1, n)
    graph += _len_field(2, b"g")
    for t in initializers:
        graph += _len_field(5, t)
    for i in inputs:
        graph += _len_field(11, value_info(i))
    for o in outputs:
        graph += _len_field(12, value_info(o))
    return _int_field(1, 8) + _len_field(7, graph)   # ir_version + graph


# ------------------------------------------------------------ OpenVINO IR

class IRBuilder:
    """Hand-build an IR xml + weight bin."""

    def __init__(self):
        self.layers = []
        self.edges = []
        self.bin = b""
        self._id = 0

    def _dims(self, shape):
        return "".join(f"<dim>{d}</dim>" for d in shape)

    def layer(self, type_, attrs=None, n_in=0, out_shape=(),
              version="opset1"):
        lid = self._id
        self._id += 1
        attr_s = ""
        if attrs:
            attr_s = "<data " + " ".join(
                f'{k}="{v}"' for k, v in attrs.items()) + "/>"
        in_s = ""
        if n_in:
            ports = "".join(
                f'<port id="{i}">{self._dims(())}</port>'
                for i in range(n_in))
            in_s = f"<input>{ports}</input>"
        out_s = ""
        if type_ != "Result":
            out_s = (f'<output><port id="{n_in}" precision="FP32">'
                     f"{self._dims(out_shape)}</port></output>")
        self.layers.append(
            f'<layer id="{lid}" name="l{lid}" type="{type_}" '
            f'version="{version}">{attr_s}{in_s}{out_s}</layer>')
        return lid, n_in  # (id, first output port index)

    def const(self, arr):
        arr = np.ascontiguousarray(arr)
        off = len(self.bin)
        self.bin += arr.tobytes()
        et = {np.dtype(np.float32): "f32", np.dtype(np.int64): "i64",
              np.dtype(np.int32): "i32"}[arr.dtype]
        return self.layer(
            "Const",
            {"element_type": et, "offset": off, "size": arr.nbytes,
             "shape": ",".join(str(d) for d in arr.shape)},
            n_in=0, out_shape=arr.shape)

    def edge(self, src, dst, dst_port):
        (sid, sport) = src
        (did, _) = dst
        self.edges.append(
            f'<edge from-layer="{sid}" from-port="{sport}" '
            f'to-layer="{did}" to-port="{dst_port}"/>')

    def build(self):
        xml = ("<net name=\"t\" version=\"10\"><layers>"
               + "".join(self.layers) + "</layers><edges>"
               + "".join(self.edges) + "</edges></net>")
        return xml.encode(), self.bin

    def write(self, tmp_path, stem="model"):
        xml, binb = self.build()
        xp = os.path.join(str(tmp_path), f"{stem}.xml")
        bp = os.path.join(str(tmp_path), f"{stem}.bin")
        with open(xp, "wb") as f:
            f.write(xml)
        with open(bp, "wb") as f:
            f.write(binb)
        return xp, bp
