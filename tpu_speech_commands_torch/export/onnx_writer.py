"""Dependency-free ONNX exporter for the four model families (counterpart
of `tpu_speech_commands/export/onnx_writer.py`: the same bytes).

Emits the ONNX protobuf wire format directly (varint tags and
length-delimited submessages), so neither the onnx package nor tf2onnx is
needed.  Graphs use only core opset-13 ops: Conv / BatchNormalization /
Clip / Relu / MaxPool / Transpose / Flatten / Gemm / Softmax for the CNNs,
and an unrolled Gemm / Sigmoid / Tanh / Mul / Add step chain for the RNNs.

I/O contract: input `feature_input` (B, n_features, feature_size[, 1]),
output `score_predict` (B, num_classes) softmax scores.  The numpy
executor for these graphs is `onnx_runtime_mini.py`.
"""
from __future__ import annotations

import struct

import numpy as np

from ..checkpoints import load_checkpoint
from ..params import pr
from ..training.checkpoints import flatten_variables

# --------------------------------------------------------------------------
# protobuf wire-format primitives
# --------------------------------------------------------------------------

FLOAT = 1  # TensorProto.DataType
INT64 = 7

_WIRE_VARINT = 0
_WIRE_I32 = 5
_WIRE_LEN = 2


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, _WIRE_VARINT) + _varint(value)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(data)) + data


def _f_string(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode())


def _f_float(field: int, value: float) -> bytes:
    return _tag(field, _WIRE_I32) + struct.pack("<f", value)


# --------------------------------------------------------------------------
# ONNX messages (field numbers from onnx.proto)
# --------------------------------------------------------------------------

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype in (np.int64, np.int32):
        arr = arr.astype(np.int64)
        dtype = INT64
    else:
        arr = arr.astype(np.float32)
        dtype = FLOAT
    msg = b"".join(_f_varint(1, int(d)) for d in arr.shape)
    msg += _f_varint(2, dtype)
    msg += _f_string(8, name)
    msg += _f_bytes(9, np.ascontiguousarray(arr).tobytes())  # raw_data
    return msg


def _attribute(name: str, value) -> bytes:
    msg = _f_string(1, name)
    if isinstance(value, float):
        msg += _f_float(2, value) + _f_varint(20, 1)  # FLOAT
    elif isinstance(value, bool) or isinstance(value, int):
        msg += _f_varint(3, int(value)) + _f_varint(20, 2)  # INT
    elif isinstance(value, str):
        msg += _f_bytes(4, value.encode()) + _f_varint(20, 3)  # STRING
    elif isinstance(value, (list, tuple)) and all(
        isinstance(v, int) for v in value
    ):
        msg += b"".join(_f_varint(8, int(v)) for v in value)
        msg += _f_varint(20, 7)  # INTS
    elif isinstance(value, (list, tuple)):
        msg += b"".join(_f_float(7, float(v)) for v in value)
        msg += _f_varint(20, 6)  # FLOATS
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return msg


def node_proto(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    msg = b"".join(_f_string(1, i) for i in inputs)
    msg += b"".join(_f_string(2, o) for o in outputs)
    msg += _f_string(3, name or outputs[0])
    msg += _f_string(4, op_type)
    msg += b"".join(_f_bytes(5, _attribute(k, v)) for k, v in attrs.items())
    return msg


def value_info(name: str, shape) -> bytes:
    dims = b""
    for d in shape:
        if d is None:
            dim = _f_string(2, "batch")  # dim_param
        else:
            dim = _f_varint(1, int(d))  # dim_value
        dims += _f_bytes(1, dim)
    tensor_type = _f_varint(1, FLOAT) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_string(1, name) + _f_bytes(2, type_proto)


def graph_proto(nodes, name, initializers, inputs, outputs) -> bytes:
    msg = b"".join(_f_bytes(1, n) for n in nodes)
    msg += _f_string(2, name)
    msg += b"".join(_f_bytes(5, t) for t in initializers)
    msg += b"".join(_f_bytes(11, vi) for vi in inputs)
    msg += b"".join(_f_bytes(12, vi) for vi in outputs)
    return msg


def model_proto(graph: bytes, opset: int = 13) -> bytes:
    opset_id = _f_string(1, "") + _f_varint(2, opset)
    msg = _f_varint(1, 8)  # ir_version
    # producer_name: the JAX package's, so both writers emit the same bytes
    msg += _f_string(2, "tpu_speech_commands")
    msg += _f_bytes(7, graph)
    msg += _f_bytes(8, opset_id)
    return msg


# --------------------------------------------------------------------------
# graph builders
# --------------------------------------------------------------------------

class _GraphBuilder:
    def __init__(self):
        self.nodes: list[bytes] = []
        self.initializers: list[bytes] = []
        self._n = 0

    def tensor(self, name: str, arr) -> str:
        self.initializers.append(tensor_proto(name, np.asarray(arr)))
        return name

    def add(self, op: str, inputs, n_out: int = 1, name: str = "", **attrs):
        self._n += 1
        base = name or f"{op.lower()}_{self._n}"
        outputs = [base] if n_out == 1 else [f"{base}_{i}" for i in range(n_out)]
        self.nodes.append(node_proto(op, inputs, outputs, base, **attrs))
        return outputs[0] if n_out == 1 else outputs

    def clip6(self, x: str, name: str) -> str:
        lo = self.tensor(f"{name}_min", np.float32(0.0))
        hi = self.tensor(f"{name}_max", np.float32(6.0))
        return self.add("Clip", [x, lo, hi], name=name)


def _cnn_graph(flat: dict, model_type: str, num_classes: int,
               input_shape) -> bytes:
    """NHWC feature_input -> Transpose(NCHW) -> conv blocks -> head.

    Block config mirrors models/cnn.py (inline relu BEFORE BatchNorm on
    block 4, and also block 3 for the lite/separable variant)."""
    g = _GraphBuilder()
    separable = model_type == "simple_cnn_lite"
    x = g.add("Transpose", ["feature_input"], name="to_nchw", perm=[0, 3, 1, 2])

    blocks = [  # (name, features, stride, inline_relu, pool)
        ("block1", 16, 1, False, True),
        ("block2", 32, 1, False, True),
        ("block3", 64, 2, separable, False),
        ("block4", 128, 1, True, True),
    ]
    for bname, feats, stride, inline_relu, pool in blocks:
        if separable:
            dw = np.asarray(flat[f"params/{bname}/depthwise/kernel"])
            # flax (H, W, 1, C) -> ONNX depthwise (C, 1, H, W), group=C
            in_ch = dw.shape[-1]
            wd = g.tensor(f"{bname}_dw", dw.transpose(3, 2, 0, 1))
            x = g.add("Conv", [x, wd], name=f"{bname}_depthwise",
                      auto_pad="SAME_UPPER", strides=[stride, stride],
                      kernel_shape=[3, 3], group=in_ch)
            pw = np.asarray(flat[f"params/{bname}/pointwise/kernel"])
            wp = g.tensor(f"{bname}_pw", pw.transpose(3, 2, 0, 1))
            bp = g.tensor(f"{bname}_pwb",
                          np.asarray(flat[f"params/{bname}/pointwise/bias"]))
            x = g.add("Conv", [x, wp, bp], name=f"{bname}_pointwise",
                      kernel_shape=[1, 1])
        else:
            k = np.asarray(flat[f"params/{bname}/conv/kernel"])
            w = g.tensor(f"{bname}_w", k.transpose(3, 2, 0, 1))
            x = g.add("Conv", [x, w], name=f"{bname}_conv",
                      auto_pad="SAME_UPPER", strides=[stride, stride],
                      kernel_shape=[3, 3])
        if inline_relu:
            x = g.add("Relu", [x], name=f"{bname}_inline_relu")
        x = g.add(
            "BatchNormalization",
            [
                x,
                g.tensor(f"{bname}_bn_s", flat[f"params/{bname}/bn/scale"]),
                g.tensor(f"{bname}_bn_b", flat[f"params/{bname}/bn/bias"]),
                g.tensor(f"{bname}_bn_m", flat[f"batch_stats/{bname}/bn/mean"]),
                g.tensor(f"{bname}_bn_v", flat[f"batch_stats/{bname}/bn/var"]),
            ],
            name=f"{bname}_bn", epsilon=1e-3,
        )
        x = g.clip6(x, f"{bname}_relu6")
        if pool:
            x = g.add("MaxPool", [x], name=f"{bname}_pool",
                      kernel_shape=[2, 2], strides=[2, 2])

    # back to NHWC so Flatten matches the JAX/Keras row order
    x = g.add("Transpose", [x], name="to_nhwc", perm=[0, 2, 3, 1])
    x = g.add("Flatten", [x], name="flatten", axis=1)
    x = g.add(
        "Gemm",
        [x, g.tensor("fd_w", flat["params/feature_dense/kernel"]),
         g.tensor("fd_b", flat["params/feature_dense/bias"])],
        name="feature_dense",
    )
    x = g.clip6(x, "feature_relu6")
    x = g.add(
        "Gemm",
        [x, g.tensor("head_w", flat["params/score_predict/kernel"]),
         g.tensor("head_b", flat["params/score_predict/bias"])],
        name="score_logits",
    )
    g.nodes.append(node_proto("Softmax", [x], ["score_predict"],
                              "score_predict_softmax", axis=-1))
    return graph_proto(
        g.nodes, model_type, g.initializers,
        [value_info("feature_input", input_shape)],
        [value_info("score_predict", (None, num_classes))],
    )


def _rnn_graph(flat: dict, model_type: str, num_classes: int,
               input_shape) -> bytes:
    """Unrolled GRU/LSTM over T timesteps (Keras gate conventions —
    models/rnn.py): only Gemm/Slice/Sigmoid/Tanh/Mul/Add/Sub nodes."""
    g = _GraphBuilder()
    cell = "gru" if model_type == "simple_gru" else "lstm"
    n_steps = int(input_shape[1])

    layers = sorted(
        {k.split("/")[2] for k in flat if f"/{cell}_unit_" in k},
        key=lambda n: int(n.rsplit("_", 1)[1]),
    )
    units = np.asarray(flat[f"params/backbone/{layers[0]}/recurrent_kernel"]).shape[0]

    def slice_cols(x, lo, hi, name):
        starts = g.tensor(f"{name}_s", np.array([lo], np.int64))
        ends = g.tensor(f"{name}_e", np.array([hi], np.int64))
        axes = g.tensor(f"{name}_a", np.array([1], np.int64))
        return g.add("Slice", [x, starts, ends, axes], name=name)

    # split the (B, T, F) input into T (B, F) steps
    steps = []
    for t in range(n_steps):
        st = g.tensor(f"t{t}_s", np.array([t], np.int64))
        en = g.tensor(f"t{t}_e", np.array([t + 1], np.int64))
        ax = g.tensor(f"t{t}_a", np.array([1], np.int64))
        sl = g.add("Slice", ["feature_input", st, en, ax], name=f"step{t}")
        sq = g.add("Squeeze", [sl, g.tensor(f"t{t}_q", np.array([1], np.int64))],
                   name=f"step{t}_sq")
        steps.append(sq)

    zero_h = g.tensor("zero_h", np.zeros((1, units), np.float32))
    for li, lname in enumerate(layers):
        p = f"params/backbone/{lname}"
        kernel = g.tensor(f"{lname}_k", flat[f"{p}/kernel"])
        recurrent = g.tensor(f"{lname}_r", flat[f"{p}/recurrent_kernel"])
        last = li == len(layers) - 1
        h = zero_h
        if cell == "lstm":
            c = zero_h
            bias = g.tensor(f"{lname}_b", flat[f"{p}/bias"])
        else:
            bias_i = g.tensor(f"{lname}_bi", flat[f"{p}/bias_input"])
            bias_r = g.tensor(f"{lname}_br", flat[f"{p}/bias_recurrent"])
        outs = []
        for t, xt in enumerate(steps):
            nm = f"{lname}_t{t}"
            if cell == "gru":
                xw = g.add("Gemm", [xt, kernel, bias_i], name=f"{nm}_xw")
                hw = g.add("Gemm", [h, recurrent, bias_r], name=f"{nm}_hw")
                xz = slice_cols(xw, 0, units, f"{nm}_xz")
                xr = slice_cols(xw, units, 2 * units, f"{nm}_xr")
                xh = slice_cols(xw, 2 * units, 3 * units, f"{nm}_xh")
                hz = slice_cols(hw, 0, units, f"{nm}_hz")
                hr = slice_cols(hw, units, 2 * units, f"{nm}_hr")
                hh = slice_cols(hw, 2 * units, 3 * units, f"{nm}_hh")
                z = g.add("Sigmoid", [g.add("Add", [xz, hz], name=f"{nm}_zs")],
                          name=f"{nm}_z")
                r = g.add("Sigmoid", [g.add("Add", [xr, hr], name=f"{nm}_rs")],
                          name=f"{nm}_r")
                # candidate activation is identity (reference rnn.py:31-35)
                cand = g.add("Add", [xh, g.add("Mul", [r, hh], name=f"{nm}_rh")],
                             name=f"{nm}_cand")
                # h' = cand + z*(h - cand)
                diff = g.add("Sub", [h, cand], name=f"{nm}_diff")
                h = g.add("Add", [cand, g.add("Mul", [z, diff], name=f"{nm}_zd")],
                          name=f"{nm}_h")
            else:
                xw = g.add("Gemm", [xt, kernel, bias], name=f"{nm}_xw")
                hw = g.add("Gemm", [h, recurrent], name=f"{nm}_hw")
                gates = g.add("Add", [xw, hw], name=f"{nm}_gates")
                i = g.add("Sigmoid", [slice_cols(gates, 0, units, f"{nm}_gi")],
                          name=f"{nm}_i")
                f = g.add("Sigmoid",
                          [slice_cols(gates, units, 2 * units, f"{nm}_gf")],
                          name=f"{nm}_f")
                gg = g.add("Tanh",
                           [slice_cols(gates, 2 * units, 3 * units, f"{nm}_gg")],
                           name=f"{nm}_g")
                o = g.add("Sigmoid",
                          [slice_cols(gates, 3 * units, 4 * units, f"{nm}_go")],
                          name=f"{nm}_o")
                fc = g.add("Mul", [f, c], name=f"{nm}_fc")
                ig = g.add("Mul", [i, gg], name=f"{nm}_ig")
                c = g.add("Add", [fc, ig], name=f"{nm}_c")
                h = g.add("Mul", [o, g.add("Tanh", [c], name=f"{nm}_ct")],
                          name=f"{nm}_h")
            outs.append(h)
        steps = outs  # feed the full sequence to the next layer

    x = g.add(
        "Gemm",
        [steps[-1], g.tensor("head_w", flat["params/score_predict/kernel"]),
         g.tensor("head_b", flat["params/score_predict/bias"])],
        name="score_logits",
    )
    g.nodes.append(node_proto("Softmax", [x], ["score_predict"],
                              "score_predict_softmax", axis=-1))
    return graph_proto(
        g.nodes, model_type, g.initializers,
        [value_info("feature_input", input_shape)],
        [value_info("score_predict", (None, num_classes))],
    )


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def write_onnx_model(output_file: str, flat: dict, model_type: str,
                     num_classes: int, n_features: int,
                     feature_size: int) -> str:
    """Emit an .onnx file from a flat {path: array} weight dict (the
    checkpoint layout: params/..., batch_stats/...)."""
    if model_type in ("simple_cnn", "simple_cnn_lite"):
        graph = _cnn_graph(flat, model_type, num_classes,
                           (None, n_features, feature_size, 1))
    elif model_type in ("simple_gru", "simple_lstm"):
        graph = _rnn_graph(flat, model_type, num_classes,
                           (None, n_features, feature_size))
    else:
        raise ValueError(f"unsupported model type: {model_type}")
    with open(output_file, "wb") as fh:
        fh.write(model_proto(graph))
    return output_file


def export_onnx_model(checkpoint_path: str, output_file: str) -> str:
    """Native .npz checkpoint -> .onnx (reference: keras_to_onnx.py)."""
    variables, meta = load_checkpoint(checkpoint_path)
    # adopt the checkpoint's audio params (as load_native does): a model
    # trained with e.g. buffer_t=2.0 or use_delta must export its own
    # n_features/feature_size, not this process's defaults
    if meta.get("params"):
        pr.override(meta["params"])
    flat = flatten_variables(variables)
    return write_onnx_model(
        output_file, flat,
        meta["model_type"], meta["num_classes"],
        meta.get("n_features", pr.n_features),
        meta.get("feature_size", pr.feature_size),
    )
