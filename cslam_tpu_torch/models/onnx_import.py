"""Minimal ONNX weight importer (no onnx/onnxruntime dependency).

Port of cslam_tpu/models/onnx_import.py (numpy only), the port's own
copy; it maps onto the flat "params/..." layout through the port's
models/convert.py, and models/superpoint.py takes it from there.

The Swarm-SLAM reference distributes its perception checkpoints as
ONNX files (its models/download.sh; its C++ descriptor component loads
.onnx/.engine, global_descriptor_component.cpp:28-38; SuperPoint +
LightGlue come from the lightglue_onnx package). This module parses the
ONNX protobuf *wire format* directly — enough to recover the graph's
initializers (weights) and node topology — and maps them onto this
port's modules via models/convert.py.

Two mapping strategies:
  1. name-based: torch.onnx.export keeps state_dict names for
     initializers ("conv1a.weight", "backbone.layer1.0.conv1.weight"),
     so the existing torch -> flat converters apply unchanged;
  2. graph-order: for optimizer-mangled names, plain CNNs (SuperPoint,
     ResNet stacks) are recovered by walking Conv/Gemm nodes in
     topological order and pairing each with its weight initializers.

Only the TensorProto dtypes that appear in these checkpoints are
supported (f32, f16, i64, i32).
"""

import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

# TensorProto.DataType values (onnx.proto)
_DTYPES = {
    1: np.float32,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
    9: np.bool_,
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Iterate (field_number, wire_type, value_or_span) over a message."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + n]
            pos += n
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    int64_data=7, name=8, raw_data=9."""
    dims: List[int] = []
    dtype = None
    name = ""
    raw = None
    floats: List[float] = []
    int64s: List[int] = []
    int32s: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 8 and wire == 2:
            name = bytes(val).decode()
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 4:
            if wire == 2:  # packed floats
                floats.extend(np.frombuffer(bytes(val), dtype="<f4"))
            elif wire == 5:
                floats.append(struct.unpack("<f", bytes(val))[0])
        elif field == 7:
            if wire == 2:
                pos = 0
                mv = memoryview(val)
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    int64s.append(v)
            elif wire == 0:
                int64s.append(val)
        elif field == 5:
            if wire == 2:
                pos = 0
                mv = memoryview(val)
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    int32s.append(v)
            elif wire == 0:
                int32s.append(val)
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np.float32)
    elif int64s:
        arr = np.asarray(int64s, dtype=np.int64)
    elif int32s:
        arr = np.asarray(int32s, dtype=np.int32)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


class OnnxNode(NamedTuple):
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]


def _parse_node(buf: memoryview) -> OnnxNode:
    """NodeProto: input=1, output=2, name=3, op_type=4."""
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(bytes(val).decode())
        elif field == 2 and wire == 2:
            outputs.append(bytes(val).decode())
        elif field == 3 and wire == 2:
            name = bytes(val).decode()
        elif field == 4 and wire == 2:
            op_type = bytes(val).decode()
    return OnnxNode(op_type, name, inputs, outputs)


def read_onnx(path: str) -> Tuple[Dict[str, np.ndarray], List[OnnxNode]]:
    """Parse an .onnx file into (initializers, nodes).

    ModelProto.graph = field 7; GraphProto.node = field 1,
    GraphProto.initializer = field 5.
    """
    with open(path, "rb") as f:
        model = memoryview(f.read())
    graph = None
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    initializers: Dict[str, np.ndarray] = {}
    nodes: List[OnnxNode] = []
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif field == 1 and wire == 2:
            nodes.append(_parse_node(val))
    return initializers, nodes


def state_dict_from_onnx(path: str) -> Dict[str, np.ndarray]:
    """Initializers as a torch-style state dict. torch.onnx.export keeps
    state_dict names, so the torch -> flat converters in models/convert.py
    consume this directly."""
    init, _ = read_onnx(path)
    return init


def conv_weights_in_graph_order(path: str):
    """[(weight, bias_or_None), ...] for every Conv/Gemm/MatMul node in
    topological order — the fallback mapping when an ONNX optimizer
    mangled initializer names (the reference's optimize.py fusion pass
    does this). Plain feed-forward CNNs (SuperPoint's 12-conv stack)
    reconstruct exactly."""
    init, nodes = read_onnx(path)
    out = []
    for node in nodes:
        if node.op_type not in ("Conv", "Gemm", "MatMul"):
            continue
        ws = [init[i] for i in node.inputs if i in init]
        if not ws:
            continue
        weight = ws[0]
        bias = ws[1] if len(ws) > 1 else None
        out.append((weight, bias))
    return out


def convert_superpoint_onnx(path: str) -> Dict[str, np.ndarray]:
    """SuperPoint .onnx -> flat npz dict (convert.superpoint_state_dict).

    Tries the torch state_dict names first (conv1a..convDb); falls back
    to graph-order conv pairing (12 convs: 8 encoder, 2 detector head,
    2 descriptor head — the fixed SuperPoint topology)."""
    from cslam_tpu_torch.models.convert import _conv, convert_superpoint

    state = state_dict_from_onnx(path)
    if "conv1a.weight" in state:
        return convert_superpoint(state)
    convs = conv_weights_in_graph_order(path)
    convs = [c for c in convs if c[0].ndim == 4]
    if len(convs) != 12:
        raise ValueError(
            f"{path}: expected SuperPoint's 12 convs, found {len(convs)}")
    out: Dict[str, np.ndarray] = {}
    for i, (w, b) in enumerate(convs):
        out[f"params/Conv_{i}/kernel"] = _conv(np.asarray(w, np.float32))
        out[f"params/Conv_{i}/bias"] = (
            np.asarray(b, np.float32) if b is not None
            else np.zeros(w.shape[0], np.float32))
    return out


def convert_cosplace_onnx(path: str) -> Dict[str, np.ndarray]:
    """EigenPlaces/CosPlace ResNet18 .onnx (export_cosplace.py output) ->
    flat npz dict (convert.cosplace_state_dict)."""
    from cslam_tpu_torch.models.convert import convert_cosplace

    state = state_dict_from_onnx(path)
    # torch.onnx.export of NetEmbedding(model) prefixes "model."
    stripped = {}
    for k, v in state.items():
        for prefix in ("model.", "module.", "net."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        stripped[k] = v
    return convert_cosplace(stripped)
