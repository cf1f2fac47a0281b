"""Minimal TFLite of the port: FlatBuffers writer, reader, and a torch executor.

The TFLite counterpart of ``utils/onnx_lite.py``.  The reference serves
HiFi-GAN through ``tf.lite.Interpreter`` (reference best_checkpoint.py:
230-260), a host runtime; neither tensorflow nor the ``flatbuffers``
package is a dependency of the port, so this module implements the slice of
TFLite's ``schema.fbs`` (version 3) that the HiFi-GAN generator needs:

 - :func:`encode_model` — serialize a :class:`Model` (one subgraph) to a
   ``.tflite`` flatbuffer: identifier ``"TFL3"``, buffer 0 the empty
   sentinel, every buffer's data little-endian and 16-byte aligned (the
   schema's ``force_align: 16``);
 - :func:`decode_model` — parse such a file back, or any file that the
   TFLite converter writes (an absent table field takes its schema
   default; an operator code is the larger of ``deprecated_builtin_code``
   and ``builtin_code``);
 - :func:`load_graph` / :func:`run_model` — execute it with torch on a
   device, the constants moved to the device once, at load time.

Ops, with TFLite's semantics: CONV_2D (NHWC input, OHWI filter, SAME or
VALID padding, strides, dilation), TRANSPOSE_CONV (inputs output_shape,
OHWI filter, input, optional bias), LEAKY_RELU, ADD and MUL (broadcasting),
RESHAPE (the shape from the second input, else ``ReshapeOptions``; one -1
allowed), TRANSPOSE and TANH.  Any other op, or a fused activation other
than NONE, raises NotImplementedError naming it.  SAME padding follows
TFLite's ``ComputePaddingHeightWidth``: the total is
``max((out - 1) * s + (k - 1) * d + 1 - in, 0)``, ``total // 2`` before and
the rest after; for TRANSPOSE_CONV ``in`` is the output_shape's size and
``out`` the size a convolution over it would give.

FlatBuffers framing: a table starts with an int32 offset back to its vtable
(uint16 vtable size, uint16 table size, one uint16 field offset per slot,
0 = absent); offsets to tables, vectors and strings are uint32, relative
to where they are stored, and point forward; a vector or string is a
uint32 count followed by its elements.  A union takes two slots: its type
(uint8) and its table.  The enum numbers and field slots below are those
of TFLite's ``schema.fbs``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IDENTIFIER = b"TFL3"
SCHEMA_VERSION = 3

# TensorType
FLOAT32, INT32 = 0, 2
_NP_DTYPE = {FLOAT32: np.dtype("<f4"), INT32: np.dtype("<i4")}

# BuiltinOperator
ADD, CONV_2D, MUL, RESHAPE, TANH, TRANSPOSE, TRANSPOSE_CONV, LEAKY_RELU = \
    0, 3, 18, 22, 28, 39, 67, 98
CUSTOM = 32
OP_NAMES = {ADD: "ADD", CONV_2D: "CONV_2D", MUL: "MUL", RESHAPE: "RESHAPE",
            TANH: "TANH", TRANSPOSE: "TRANSPOSE",
            TRANSPOSE_CONV: "TRANSPOSE_CONV", LEAKY_RELU: "LEAKY_RELU",
            CUSTOM: "CUSTOM"}

# Padding, ActivationFunctionType
SAME, VALID = 0, 1
ACTIVATION_NONE = 0

# BuiltinOptions union: type number -> (field, slot, struct format, default)
# in table order; "[i" is a vector of int32.
OPTIONS_OF_OP = {CONV_2D: 1, ADD: 11, RESHAPE: 17, MUL: 21,
                 TRANSPOSE_CONV: 49, LEAKY_RELU: 75}
OPTION_FIELDS = {
    1: (("padding", 0, "b", SAME), ("stride_w", 1, "i", 0),
        ("stride_h", 2, "i", 0), ("fused_activation_function", 3, "b", 0),
        ("dilation_w_factor", 4, "i", 1), ("dilation_h_factor", 5, "i", 1)),
    11: (("fused_activation_function", 0, "b", 0),
         ("pot_scale_int16", 1, "?", True)),
    17: (("new_shape", 0, "[i", None),),
    21: (("fused_activation_function", 0, "b", 0),),
    26: (),
    49: (("padding", 0, "b", SAME), ("stride_w", 1, "i", 0),
         ("stride_h", 2, "i", 0), ("fused_activation_function", 3, "b", 0)),
    75: (("alpha", 0, "f", 0.0),),
}

# the version TFLite's op_version rules give an op as HiFi-GAN uses it
# (CONV_2D with dilation, TRANSPOSE_CONV with a bias); 1 for the others
OP_VERSION = {CONV_2D: 2, TRANSPOSE_CONV: 3}


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Tensor:
    name: str
    shape: Tuple[int, ...]
    dtype: int = FLOAT32               # TensorType
    data: Optional[np.ndarray] = None  # a constant when set


@dataclasses.dataclass
class Op:
    code: int                          # BuiltinOperator
    inputs: List[int]                  # tensor indices, -1 = absent
    outputs: List[int]
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = 1


@dataclasses.dataclass
class Model:
    tensors: List[Tensor]
    ops: List[Op]
    inputs: List[int]
    outputs: List[int]
    description: str = ""


def op_name(code: int) -> str:
    return OP_NAMES.get(code, f"builtin op {code}")


def full_options(code: int, options: Dict[str, Any]) -> Dict[str, Any]:
    """``options`` with every field of the op's options table, the absent
    ones at their schema default (what :func:`decode_model` returns)."""
    fields = OPTION_FIELDS.get(OPTIONS_OF_OP.get(code, 0), ())
    out = {name: default for name, _, _, default in fields}
    out.update(options)
    return out


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------


class _Table(NamedTuple):
    fields: Dict[int, Tuple[str, Any]]   # slot -> (format, value)


class _Vector(NamedTuple):
    fmt: str          # struct format of a scalar element, or "o" (tables)
    items: Any
    align: int = 4


class _String(NamedTuple):
    text: bytes


_SIZE = {"b": 1, "B": 1, "?": 1, "h": 2, "H": 2, "i": 4, "I": 4, "f": 4,
         "q": 8, "Q": 8, "o": 4}


class _Writer:
    """Lays objects out front to back: an object's children follow it, so
    every uint32 offset points forward."""

    def __init__(self):
        self.buf = bytearray(IDENTIFIER.rjust(8, b"\0"))   # root offset, id

    def _pad(self, align: int, extra: int = 0):
        self.buf += bytes(-(len(self.buf) + extra) % align)

    def _patch(self, at: int, target: int):
        struct.pack_into("<I", self.buf, at, target - at)

    def write(self, obj) -> int:
        if isinstance(obj, _Table):
            return self._table(obj)
        if isinstance(obj, _String):
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(obj.text)) + obj.text + b"\0"
            return at
        return self._vector(obj)

    def _table(self, t: _Table) -> int:
        slots = sorted(t.fields, key=lambda s: -_SIZE[t.fields[s][0]])
        layout, off = {}, 4
        for s in slots:
            size = _SIZE[t.fields[s][0]]
            off += -off % size
            layout[s] = off
            off += size
        n = max(t.fields, default=-1) + 1
        self._pad(2)
        vtable = len(self.buf)
        self.buf += struct.pack(f"<HH{n}H", 4 + 2 * n, off,
                                *(layout.get(s, 0) for s in range(n)))
        self._pad(8)
        at = len(self.buf)
        body = bytearray(off)
        struct.pack_into("<i", body, 0, at - vtable)
        children = []
        for s, (fmt, val) in t.fields.items():
            if fmt == "o":
                children.append((at + layout[s], val))
            else:
                struct.pack_into("<" + fmt, body, layout[s], val)
        self.buf += body
        for field_at, child in children:
            self._patch(field_at, self.write(child))
        return at

    def _vector(self, v: _Vector) -> int:
        if v.fmt == "o":
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(v.items)) \
                + bytes(4 * len(v.items))
            for i, child in enumerate(v.items):
                self._patch(at + 4 + 4 * i, self.write(child))
            return at
        data = (v.items if isinstance(v.items, (bytes, bytearray))
                else np.asarray(v.items, "<" + v.fmt).tobytes())
        self._pad(max(v.align, _SIZE[v.fmt]), extra=4)
        at = len(self.buf)
        self.buf += struct.pack("<I", len(data) // _SIZE[v.fmt]) + data
        return at


def _options_table(code: int, options: Dict[str, Any]) -> Optional[_Table]:
    kind = OPTIONS_OF_OP.get(code)
    if kind is None:
        return None
    fields = {}
    for name, slot, fmt, default in OPTION_FIELDS[kind]:
        val = options.get(name, default)
        if fmt == "[i":
            if val is not None:
                fields[slot] = ("o", _Vector("i", [int(x) for x in val]))
        elif val != default:
            fields[slot] = (fmt, val)
    return _Table(fields)


def encode_model(model: Model) -> bytes:
    """``model`` as a ``.tflite`` flatbuffer (one subgraph; each constant
    in its own buffer, the others on buffer 0)."""
    codes = sorted({op.code for op in model.ops})
    versions = {c: max(op.version for op in model.ops if op.code == c)
                for c in codes}
    buffers = [_Table({})]
    tensors = []
    for t in model.tensors:
        fields = {0: ("o", _Vector("i", [int(d) for d in t.shape])),
                  3: ("o", _String(t.name.encode()))}
        if t.dtype != FLOAT32:
            fields[1] = ("b", t.dtype)
        if t.data is not None:
            data = np.asarray(t.data, _NP_DTYPE[t.dtype])
            if data.shape != tuple(t.shape):
                raise ValueError(f"tensor {t.name}: data {data.shape} "
                                 f"against shape {tuple(t.shape)}")
            fields[2] = ("I", len(buffers))
            buffers.append(_Table({0: ("o", _Vector("B", data.tobytes(),
                                                    align=16))}))
        tensors.append(_Table(fields))
    operators = []
    for op in model.ops:
        fields = {1: ("o", _Vector("i", op.inputs)),
                  2: ("o", _Vector("i", op.outputs))}
        if op.code != codes[0]:
            fields[0] = ("I", codes.index(op.code))
        opts = _options_table(op.code, op.options)
        if opts is not None:
            fields[3] = ("B", OPTIONS_OF_OP[op.code])
            fields[4] = ("o", opts)
        operators.append(_Table(fields))
    subgraph = _Table({0: ("o", _Vector("o", tensors)),
                       1: ("o", _Vector("i", model.inputs)),
                       2: ("o", _Vector("i", model.outputs)),
                       3: ("o", _Vector("o", operators)),
                       4: ("o", _String(b"main"))})
    opcodes = [_Table({0: ("b", min(c, 127)), 2: ("i", versions[c]),
                       3: ("i", c)}) for c in codes]
    root = _Table({0: ("I", SCHEMA_VERSION),
                   1: ("o", _Vector("o", opcodes)),
                   2: ("o", _Vector("o", [subgraph])),
                   3: ("o", _String(model.description.encode())),
                   4: ("o", _Vector("o", buffers))})
    w = _Writer()
    w._patch(0, w.write(root))
    return bytes(w.buf)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------


class _Reader:
    """One table of a flatbuffer: scalar fields with their defaults, and
    the positions of the objects its offset fields point to."""

    def __init__(self, buf, at: int):
        self.buf, self.at = buf, at
        self.vtable = at - struct.unpack_from("<i", buf, at)[0]
        self.vsize = struct.unpack_from("<H", buf, self.vtable)[0]

    def _field(self, slot: int) -> int:
        o = 4 + 2 * slot
        return (struct.unpack_from("<H", self.buf, self.vtable + o)[0]
                if o < self.vsize else 0)

    def scalar(self, slot: int, fmt: str, default):
        o = self._field(slot)
        return (struct.unpack_from("<" + fmt, self.buf, self.at + o)[0]
                if o else default)

    def _target(self, slot: int) -> Optional[int]:
        o = self._field(slot)
        if not o:
            return None
        at = self.at + o
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, slot: int) -> Optional["_Reader"]:
        at = self._target(slot)
        return None if at is None else _Reader(self.buf, at)

    def tables(self, slot: int) -> List["_Reader"]:
        at = self._target(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for i in range(n):
            p = at + 4 + 4 * i
            out.append(_Reader(self.buf,
                               p + struct.unpack_from("<I", self.buf, p)[0]))
        return out

    def vector(self, slot: int, fmt: str) -> Optional[np.ndarray]:
        at = self._target(slot)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        return np.frombuffer(self.buf, "<" + fmt, count=n, offset=at + 4)

    def string(self, slot: int) -> str:
        raw = self.vector(slot, "B")
        return "" if raw is None else raw.tobytes().decode("utf-8", "replace")


def _decode_options(kind: int, r: Optional[_Reader]) -> Dict[str, Any]:
    out = {}
    for name, slot, fmt, default in OPTION_FIELDS.get(kind, ()):
        if fmt == "[i":
            v = None if r is None else r.vector(slot, "i")
            out[name] = None if v is None else [int(x) for x in v]
        else:
            v = default if r is None else r.scalar(slot, fmt, default)
            out[name] = (bool(v) if fmt == "?" else
                         float(v) if fmt == "f" else int(v))
    return out


def decode_model(data: bytes) -> Model:
    """A ``.tflite`` flatbuffer's first subgraph as a :class:`Model`
    (constants as numpy arrays; a custom op keeps code CUSTOM and its name
    in ``options["custom_code"]``)."""
    buf = memoryview(data)
    if bytes(buf[4:8]) != IDENTIFIER:
        raise ValueError(f"not a TFLite flatbuffer (identifier "
                         f"{bytes(buf[4:8])!r})")
    root = _Reader(buf, struct.unpack_from("<I", buf, 0)[0])
    codes = []
    for c in root.tables(1):
        code = max(c.scalar(0, "b", 0), c.scalar(3, "i", 0))
        custom = c.string(1) if c._field(1) else None
        codes.append((CUSTOM if custom is not None else code, custom,
                      c.scalar(2, "i", 1)))
    buffers = [b.vector(0, "B") for b in root.tables(4)]
    graphs = root.tables(2)
    if not graphs:
        raise ValueError("the model has no subgraph")
    g = graphs[0]
    tensors = []
    for t in g.tables(0):
        shape = t.vector(0, "i")
        shape = () if shape is None else tuple(int(d) for d in shape)
        dtype, bi = t.scalar(1, "b", FLOAT32), t.scalar(2, "I", 0)
        name = t.string(3)
        raw = buffers[bi] if bi < len(buffers) else None
        arr = None
        if raw is not None and raw.size:
            if dtype not in _NP_DTYPE:
                raise NotImplementedError(f"tensor {name}: TensorType {dtype}")
            arr = np.frombuffer(raw.tobytes(), _NP_DTYPE[dtype]).reshape(
                shape)
        tensors.append(Tensor(name, shape, dtype, arr))
    ops = []
    for o in g.tables(3):
        code, custom, version = codes[o.scalar(0, "I", 0)]
        kind = o.scalar(3, "B", 0)
        opts = _decode_options(kind, o.table(4))
        if custom is not None:
            opts["custom_code"] = custom
        ops.append(Op(code, [int(i) for i in o.vector(1, "i")],
                      [int(i) for i in o.vector(2, "i")], opts, version))
    return Model(tensors, ops, [int(i) for i in g.vector(1, "i")],
                 [int(i) for i in g.vector(2, "i")], root.string(3))


# --------------------------------------------------------------------------
# torch executor
# --------------------------------------------------------------------------


class Graph(NamedTuple):
    """A decoded model with its constants on one device, the filters of
    its one-dimensional convolutions in ``F.conv1d`` / ``conv_transpose1d``
    layout, and the step after which each tensor is no longer read."""
    model: Model
    consts: Dict[int, torch.Tensor]
    filters: Dict[int, torch.Tensor]   # op index -> [O, I, k] / [I, O, k]
    last_use: Dict[int, int]


def load_graph(model: Model, device) -> Graph:
    """``model``'s constants moved to ``device`` once, and the OHWI filter
    of each convolution whose kernel is 1 wide or 1 high laid out for the
    one-dimensional torch convolution along its other axis."""
    consts = {i: torch.from_numpy(np.array(t.data)).to(device)
              for i, t in enumerate(model.tensors) if t.data is not None}
    filters = {}
    for k, op in enumerate(model.ops):
        w = consts.get(op.inputs[1]) if op.code in (
            CONV_2D, TRANSPOSE_CONV) else None
        if w is None or 1 not in w.shape[1:3]:
            continue
        w = w[:, 0] if w.shape[1] == 1 else w[:, :, 0]       # [O, k, I]
        filters[k] = (w.permute(0, 2, 1) if op.code == CONV_2D
                      else w.permute(2, 0, 1)).contiguous()
    last_use = {}
    for k, op in enumerate(model.ops):
        for i in op.inputs:
            last_use[i] = k
    for i in model.outputs:
        last_use[i] = len(model.ops)
    return Graph(model, consts, filters, last_use)


def _ints(graph: Graph, env, i: int) -> List[int]:
    """An int32 operand (a shape or a permutation) as host ints: the
    file's constant, never a device read, when it is one."""
    data = graph.model.tensors[i].data
    if data is not None:
        return [int(v) for v in np.asarray(data).reshape(-1)]
    return [int(v) for v in env[i].reshape(-1).tolist()]


def _same_pad(in_size: int, out_size: int, k: int, s: int, d: int
              ) -> Tuple[int, int]:
    """TFLite's SAME padding (before, after) of one axis."""
    total = max((out_size - 1) * s + (k - 1) * d + 1 - in_size, 0)
    return total // 2, total - total // 2


def _check_activation(op: Op):
    act = op.options.get("fused_activation_function", ACTIVATION_NONE)
    if act != ACTIVATION_NONE:
        raise NotImplementedError(
            f"{op_name(op.code)} with fused activation {act}")


def _line_axis(x: torch.Tensor, kh: int, kw: int, out_hw=(1, 1)):
    """The spatial axis (1 = H, 2 = W) along which an NHWC convolution is
    one-dimensional (the other axis 1 long in the input, the filter and
    ``out_hw``), else None.  Along it the op runs as ``F.conv1d`` on the
    [B, C, L] view of the activations, which stays dense from one
    convolution to the next: no layout copies."""
    if x.shape[1] == 1 and kh == 1 and out_hw[0] == 1:
        return 2
    if x.shape[2] == 1 and kw == 1 and out_hw[1] == 1:
        return 1
    return None


def _to_line(x: torch.Tensor, axis: int) -> torch.Tensor:
    return (x[:, 0] if axis == 2 else x[:, :, 0]).permute(0, 2, 1)


def _from_line(y: torch.Tensor, axis: int) -> torch.Tensor:
    y = y.permute(0, 2, 1)
    return y[:, None] if axis == 2 else y[:, :, None]


def _conv2d(graph: Graph, k: int, op: Op, env) -> torch.Tensor:
    """CONV_2D: x NHWC, filter OHWI -> NHWC."""
    o = op.options
    x, w = env[op.inputs[0]], env[op.inputs[1]]
    b = env[op.inputs[2]] if len(op.inputs) > 2 and op.inputs[2] >= 0 \
        else None
    s = (o["stride_h"], o["stride_w"])
    d = (o["dilation_h_factor"], o["dilation_w_factor"])
    pads = [(0, 0), (0, 0)]
    if o["padding"] == SAME:
        pads = [_same_pad(x.shape[1 + a], -(-x.shape[1 + a] // s[a]),
                          w.shape[1 + a], s[a], d[a]) for a in (0, 1)]
    axis = _line_axis(x, w.shape[1], w.shape[2])
    if axis is not None and k in graph.filters:
        a = axis - 1
        xl, (p0, p1) = _to_line(x, axis), pads[a]
        if p0 != p1:
            xl, p0 = F.pad(xl, (p0, p1)), 0
        return _from_line(F.conv1d(xl, graph.filters[k], b, s[a], p0, d[a]),
                          axis)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
    (ht, hb), (wl, wr) = pads
    if ht == hb and wl == wr:
        y = F.conv2d(xc, wc, b, s, (ht, wl), d)
    else:
        y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), wc, b, s, 0, d)
    return y.permute(0, 2, 3, 1)


def _convt_axis(out: int, in_: int, k: int, s: int, padding: int
                ) -> Tuple[int, int, int]:
    """One axis of TRANSPOSE_CONV: (torch padding, crop before, output
    padding) so that the result is the full transposed convolution
    ((in - 1) * s + k samples) from TFLite's pad-before on, ``out`` long,
    the bias alone where it runs past the full result."""
    conv_out = (-(-out // s) if padding == SAME else (out - k + s) // s)
    before = max((conv_out - 1) * s + k - out, 0) // 2
    full = (in_ - 1) * s + k
    after = full - before - out          # < 0: past the full result
    if after >= 0:
        p = min(before, after)
        return p, before - p, 0
    return before, 0, -after


def _transpose_conv(graph: Graph, k: int, op: Op, env) -> torch.Tensor:
    """TRANSPOSE_CONV: inputs output_shape, filter OHWI, x NHWC, bias."""
    o = op.options
    shape = _ints(graph, env, op.inputs[0])
    w, x = env[op.inputs[1]], env[op.inputs[2]]
    b = (env[op.inputs[3]] if len(op.inputs) > 3 and op.inputs[3] >= 0
         else None)
    s = (o["stride_h"], o["stride_w"])
    axes = [_convt_axis(shape[1 + a], x.shape[1 + a], w.shape[1 + a], s[a],
                        o["padding"]) for a in (0, 1)]
    if any(extra >= s[a] for a, (_, _, extra) in enumerate(axes)):
        raise NotImplementedError(
            f"TRANSPOSE_CONV to {shape}: past its full result by a stride "
            f"or more")
    axis = _line_axis(x, w.shape[1], w.shape[2], shape[1:3])
    if axis is not None and k in graph.filters:
        a = axis - 1
        (p, c, extra), n = axes[a], shape[axis]
        y = F.conv_transpose1d(_to_line(x, axis), graph.filters[k], b, s[a],
                               p, extra)
        return _from_line(y[:, :, c:c + n], axis)
    (ph, ch, oh), (pw, cw, ow) = axes
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(3, 0, 1, 2), b,
                           s, (ph, pw), (oh, ow))
    return y[:, :, ch:ch + shape[1], cw:cw + shape[2]].permute(0, 2, 3, 1)


def _reshape(graph: Graph, op: Op, env) -> torch.Tensor:
    x = env[op.inputs[0]]
    if len(op.inputs) > 1 and op.inputs[1] >= 0:
        shape = _ints(graph, env, op.inputs[1])
    else:
        shape = op.options.get("new_shape")
        if shape is None:
            shape = list(graph.model.tensors[op.outputs[0]].shape)
    return x.reshape(shape)


def run_model(graph: Graph, feeds: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Execute ``graph`` on f32 ``feeds`` (one per model input, in order,
    on the graph's device); returns the model's outputs on that device.  A
    feed whose shape is not the input tensor's raises ValueError: like the
    JAX CLI's interpreter, a file whose reshape constants are fixed runs
    only at its own shape."""
    model = graph.model
    env: Dict[int, torch.Tensor] = dict(graph.consts)
    if len(feeds) != len(model.inputs):
        raise ValueError(f"{len(feeds)} inputs for a model of "
                         f"{len(model.inputs)}")
    for i, x in zip(model.inputs, feeds):
        want = tuple(model.tensors[i].shape)
        if tuple(x.shape) != want:
            raise ValueError(f"input {model.tensors[i].name!r}: shape "
                             f"{tuple(x.shape)}, the file's is {want}")
        env[i] = x.to(torch.float32)
    for k, op in enumerate(model.ops):
        code, o = op.code, op.options
        if code == CONV_2D:
            _check_activation(op)
            y = _conv2d(graph, k, op, env)
        elif code == TRANSPOSE_CONV:
            _check_activation(op)
            y = _transpose_conv(graph, k, op, env)
        elif code == LEAKY_RELU:
            y = F.leaky_relu(env[op.inputs[0]], o["alpha"])
        elif code in (ADD, MUL):
            _check_activation(op)
            a, b = env[op.inputs[0]], env[op.inputs[1]]
            y = a + b if code == ADD else a * b
        elif code == RESHAPE:
            y = _reshape(graph, op, env)
        elif code == TRANSPOSE:
            y = env[op.inputs[0]].permute(_ints(graph, env, op.inputs[1]))
        elif code == TANH:
            y = torch.tanh(env[op.inputs[0]])
        else:
            name = (f"CUSTOM {o['custom_code']}" if code == CUSTOM
                    else op_name(code))
            raise NotImplementedError(f"TFLite op {name}")
        env[op.outputs[0]] = y
        for i in op.inputs:
            if graph.last_use.get(i) == k and i not in graph.consts:
                env.pop(i, None)
    return [env[i] for i in model.outputs]
