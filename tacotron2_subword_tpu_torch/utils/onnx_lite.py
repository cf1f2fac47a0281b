"""Minimal ONNX of the port: protobuf writer, reader, and a torch executor.

The port's own copy of ``tacotron2_subword_tpu/utils/onnx_lite.py``.  The
reference serves HiFi-GAN through onnxruntime (reference
inference.py:208-223, best_checkpoint.py:230-260); neither the ``onnx``
package nor ``onnxruntime`` is a dependency, so this module implements the
slice of ONNX the vocoder path needs:

 - :func:`encode_model` — serialize a 1-D conv graph to an ONNX
   ``ModelProto`` (protobuf wire format emitted directly; opset 13), byte
   for byte as the JAX package's;
 - :func:`decode_model` — parse such a file back (any onnx-produced file
   whose ops fall in the supported set), as the JAX package's;
 - :func:`load_graph` / :func:`run_model` — execute it with torch on a
   device (Conv / ConvTranspose / LeakyRelu / Tanh / Add / Mul over
   [B, C, T] tensors, the HiFi-GAN generator's op vocabulary), the
   initializers moved to the device once, at load time.

Protobuf framing follows the public onnx.proto3 schema field numbers:
ModelProto{ir_version=1, producer=2, graph=7, opset_import=8},
GraphProto{node=1, name=2, initializer=5, input=11, output=12},
NodeProto{input=1, output=2, name=3, op_type=4, attribute=5},
AttributeProto{name=1, f=2, i=3, s=4, floats=7, ints=8, type=20},
TensorProto{dims=1, data_type=2, float_data=4, name=8, raw_data=9}.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# protobuf wire-format primitives
# --------------------------------------------------------------------------


def _uv(n: int) -> bytes:
    """Unsigned varint."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wt: int) -> bytes:
    return _uv((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _key(field, 2) + _uv(len(payload)) + payload


def _vi(field: int, val: int) -> bytes:
    return _key(field, 0) + _uv(val)


def _f32(field: int, val: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", val)


def _packed_ints(field: int, vals: Sequence[int]) -> bytes:
    return _ld(field, b"".join(_uv(v) for v in vals))


# --------------------------------------------------------------------------
# graph model
# --------------------------------------------------------------------------

AttrVal = Union[int, float, str, Sequence[int], Sequence[float]]


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, AttrVal] = dataclasses.field(default_factory=dict)


def _attr_bytes(name: str, val: AttrVal) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(val, bool):
        raise TypeError("bool attribute ambiguous; use int")
    if isinstance(val, int):
        out += _vi(3, val) + _vi(20, 2)               # INT
    elif isinstance(val, float):
        out += _f32(2, val) + _vi(20, 1)              # FLOAT
    elif isinstance(val, str):
        out += _ld(4, val.encode()) + _vi(20, 3)      # STRING
    elif all(isinstance(v, (int, np.integer)) for v in val):
        out += _packed_ints(8, [int(v) for v in val]) + _vi(20, 7)   # INTS
    else:
        out += _ld(7, b"".join(struct.pack("<f", float(v)) for v in val)) \
            + _vi(20, 6)                              # FLOATS
    return out


def _node_bytes(n: Node) -> bytes:
    out = b"".join(_ld(1, i.encode()) for i in n.inputs)
    out += b"".join(_ld(2, o.encode()) for o in n.outputs)
    out += _ld(4, n.op_type.encode())
    out += b"".join(_ld(5, _attr_bytes(k, v)) for k, v in n.attrs.items())
    return out


def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    out = _packed_ints(1, arr.shape)
    out += _vi(2, 1)                                  # FLOAT
    out += _ld(8, name.encode())
    out += _ld(9, arr.astype("<f4").tobytes())
    return out


def _value_info_bytes(name: str, shape: Sequence[Union[int, str]]) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _ld(1, _ld(2, d.encode()))        # dim_param
        else:
            dims += _ld(1, _vi(1, int(d)))            # dim_value
    tensor_type = _vi(1, 1) + _ld(2, dims)            # elem_type FLOAT
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def encode_model(nodes: Sequence[Node],
                 initializers: Dict[str, np.ndarray],
                 inputs: Dict[str, Sequence[Union[int, str]]],
                 outputs: Dict[str, Sequence[Union[int, str]]],
                 graph_name: str = "graph",
                 producer: str = "tacotron2_subword_tpu_torch",
                 opset: int = 13) -> bytes:
    g = b"".join(_ld(1, _node_bytes(n)) for n in nodes)
    g += _ld(2, graph_name.encode())
    g += b"".join(_ld(5, _tensor_bytes(k, v))
                  for k, v in initializers.items())
    g += b"".join(_ld(11, _value_info_bytes(k, s))
                  for k, s in inputs.items())
    g += b"".join(_ld(12, _value_info_bytes(k, s))
                  for k, s in outputs.items())
    m = _vi(1, 7)                                     # ir_version 7
    m += _ld(2, producer.encode())
    m += _ld(7, g)
    m += _ld(8, _ld(1, b"") + _vi(2, opset))          # default domain opset
    return m


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------


def _parse_fields(buf: bytes) -> Dict[int, list]:
    """Generic protobuf scan: field → list of raw values (int for varint /
    fixed, bytes for length-delimited)."""
    out: Dict[int, list] = {}
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wt == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:
            val = buf[i:i + 4]
            i += 4
        elif wt == 1:
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append(val)
    return out


def _ints_of(raw_list) -> List[int]:
    """Repeated int64 field: packed bytes or individual varints."""
    vals: List[int] = []
    for item in raw_list:
        if isinstance(item, int):
            vals.append(item)
        else:
            vals.extend(_parse_varints(item))
    return vals


def _parse_varints(buf: bytes) -> List[int]:
    out, i, n = [], 0, len(buf)
    while i < n:
        val = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            val |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        out.append(val)
    return out


def _decode_attr(buf: bytes) -> Tuple[str, AttrVal]:
    f = _parse_fields(buf)
    name = f[1][0].decode()
    atype = f.get(20, [0])[0]
    if atype == 2 or (atype == 0 and 3 in f):
        return name, f[3][0]
    if atype == 1 or (atype == 0 and 2 in f):
        return name, struct.unpack("<f", f[2][0])[0]
    if atype == 3 or (atype == 0 and 4 in f):
        return name, f[4][0].decode()
    if atype == 7 or (atype == 0 and 8 in f):
        return name, _ints_of(f.get(8, []))
    if atype == 6 or (atype == 0 and 7 in f):
        raw = b"".join(f[7]) if isinstance(f[7][0], bytes) else b""
        return name, list(np.frombuffer(raw, "<f4"))
    raise ValueError(f"unsupported attribute type {atype} for {name}")


def _decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = _parse_fields(buf)
    dims = _ints_of(f.get(1, []))
    dtype = f.get(2, [1])[0]
    name = f.get(8, [b""])[0].decode()
    if 9 in f:                                       # raw_data
        if dtype == 1:
            arr = np.frombuffer(f[9][0], "<f4")
        elif dtype == 7:
            arr = np.frombuffer(f[9][0], "<i8")
        elif dtype == 6:
            arr = np.frombuffer(f[9][0], "<i4")
        else:
            raise ValueError(f"unsupported tensor data_type {dtype}")
    elif 4 in f:                                     # float_data
        raw = b"".join(v for v in f[4] if isinstance(v, bytes))
        arr = np.frombuffer(raw, "<f4") if raw else np.asarray(
            [struct.unpack("<f", v)[0] for v in f[4]], np.float32)
    else:
        arr = np.zeros(0, np.float32)
    return name, arr.reshape(dims) if dims else arr


def decode_model(data: bytes):
    """→ (nodes, initializers, input_names, output_names)."""
    model = _parse_fields(data)
    graph = _parse_fields(model[7][0])
    nodes = []
    for nb in graph.get(1, []):
        f = _parse_fields(nb)
        nodes.append(Node(
            op_type=f[4][0].decode(),
            inputs=[v.decode() for v in f.get(1, [])],
            outputs=[v.decode() for v in f.get(2, [])],
            attrs=dict(_decode_attr(a) for a in f.get(5, []))))
    inits = dict(_decode_tensor(t) for t in graph.get(5, []))
    def names(field):
        out = []
        for vb in graph.get(field, []):
            out.append(_parse_fields(vb)[1][0].decode())
        return out
    return nodes, inits, names(11), names(12)


# --------------------------------------------------------------------------
# torch executor (1-D conv graphs)
# --------------------------------------------------------------------------


class Graph(NamedTuple):
    """A decoded model with its initializers as tensors on one device."""
    nodes: List[Node]
    inits: Dict[str, torch.Tensor]
    input_names: List[str]
    output_names: List[str]


def load_graph(decoded, device) -> Graph:
    """``decode_model``'s result with every initializer moved to
    ``device`` (f32 for float data) once."""
    nodes, inits, in_names, out_names = decoded
    tensors = {}
    for k, v in inits.items():
        a = np.ascontiguousarray(v)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        tensors[k] = torch.from_numpy(a.copy()).to(device)
    return Graph(list(nodes), tensors, list(in_names), list(out_names))


def _first(a, key: str, default: int) -> int:
    return int(list(a.get(key, [default]))[0])


def _conv(x, w, b, a) -> torch.Tensor:
    pads = [int(v) for v in a.get("pads", [0, 0])]
    if pads[0] != pads[1]:
        x = F.pad(x, (pads[0], pads[1]))
        pads = [0, 0]
    return F.conv1d(x, w, b, stride=_first(a, "strides", 1),
                    padding=pads[0], dilation=_first(a, "dilations", 1),
                    groups=int(a.get("group", 1)))


def _conv_transpose(x, w, b, a) -> torch.Tensor:
    # group=1 / dilation=1 / no output_padding only: anything else is
    # rejected rather than run as silently wrong audio on a foreign file
    if int(a.get("group", 1)) != 1 \
            or list(a.get("dilations", [1])) != [1] \
            or any(int(v) for v in a.get("output_padding", [])):
        raise NotImplementedError(
            "ConvTranspose with group/dilations/output_padding "
            f"attrs is not supported (got {a})")
    pads = [int(v) for v in a.get("pads", [0, 0])]
    y = F.conv_transpose1d(x, w, b, stride=_first(a, "strides", 1),
                           padding=min(pads))
    extra = pads[0] - pads[1]   # asymmetric pads: trim the larger side
    if extra > 0:
        y = y[..., extra:]
    elif extra < 0:
        y = y[..., :extra]
    return y


def run_model(graph: Graph, feeds: Dict[str, torch.Tensor]
              ) -> List[torch.Tensor]:
    """Execute ``graph`` on f32 ``feeds`` (tensors on the graph's device);
    returns the graph outputs, f32, on that device."""
    env: Dict[str, torch.Tensor] = dict(graph.inits)
    env.update({k: v.to(torch.float32) for k, v in feeds.items()})
    for n in graph.nodes:
        a = n.attrs
        args = [env[i] for i in n.inputs]
        if n.op_type == "Conv":
            y = _conv(args[0], args[1], args[2] if len(args) > 2 else None, a)
        elif n.op_type == "ConvTranspose":
            y = _conv_transpose(args[0], args[1],
                                args[2] if len(args) > 2 else None, a)
        elif n.op_type == "LeakyRelu":
            y = F.leaky_relu(args[0], float(a.get("alpha", 0.01)))
        elif n.op_type == "Tanh":
            y = torch.tanh(args[0])
        elif n.op_type == "Add":
            y = args[0] + args[1]
        elif n.op_type == "Mul":
            y = args[0] * args[1]
        else:
            raise NotImplementedError(f"op {n.op_type}")
        env[n.outputs[0]] = y.to(torch.float32)
    return [env[o] for o in graph.output_names]
