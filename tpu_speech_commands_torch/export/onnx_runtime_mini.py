"""Minimal numpy ONNX executor for the graphs onnx_writer.py emits
(counterpart of `tpu_speech_commands/export/onnx_runtime_mini.py`).

A strict protobuf wire-format parser plus numpy implementations of the
core opset the exporter uses (Conv / BatchNormalization / Clip / Relu /
MaxPool / Transpose / Flatten / Gemm / Softmax / Slice / Squeeze /
elementwise).  It rejects anything it does not understand: it is a
verification oracle and the host runtime where onnxruntime is not
installed, not a general runtime.

Usage:  OnnxModel(path).run({"feature_input": x})["score_predict"]
"""
from __future__ import annotations

import struct

import numpy as np

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
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
    """Yield (field_number, wire_type, value) triples of one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _WIRE_LEN:
            size, pos = _read_varint(buf, pos)
            value = buf[pos : pos + size]
            pos += size
        elif wire == _WIRE_I32:
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == _WIRE_I64:
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims, dtype, name, raw = [], 1, "", b""
    float_data, int64_data = [], []
    for field, _, value in _fields(buf):
        if field == 1:
            dims.append(value)
        elif field == 2:
            dtype = value
        elif field == 8:
            name = bytes(value).decode()
        elif field == 9:
            raw = bytes(value)
        elif field == 4:
            float_data.append(struct.unpack("<f", value)[0])
        elif field == 7:
            int64_data.append(value)
    if dtype == 1:
        arr = (np.frombuffer(raw, "<f4") if raw
               else np.asarray(float_data, np.float32))
    elif dtype == 7:
        arr = (np.frombuffer(raw, "<i8") if raw
               else np.asarray(int64_data, np.int64))
    else:
        raise ValueError(f"unsupported tensor dtype {dtype}")
    return name, arr.reshape(dims)


def _parse_attribute(buf: memoryview):
    name, value = "", None
    ints, floats = [], []
    for field, wire, raw in _fields(buf):
        if field == 1:
            name = bytes(raw).decode()
        elif field == 2:
            value = struct.unpack("<f", raw)[0]
        elif field == 3:
            value = raw if raw < (1 << 63) else raw - (1 << 64)
        elif field == 4:
            value = bytes(raw).decode()
        elif field == 7:
            floats.append(struct.unpack("<f", raw)[0])
        elif field == 8:
            ints.append(raw if raw < (1 << 63) else raw - (1 << 64))
    if ints:
        value = ints
    elif floats:
        value = floats
    return name, value


def _parse_node(buf: memoryview):
    inputs, outputs, op_type, attrs = [], [], "", {}
    for field, _, value in _fields(buf):
        if field == 1:
            inputs.append(bytes(value).decode())
        elif field == 2:
            outputs.append(bytes(value).decode())
        elif field == 4:
            op_type = bytes(value).decode()
        elif field == 5:
            k, v = _parse_attribute(value)
            attrs[k] = v
    return op_type, inputs, outputs, attrs


def _vi_name(buf: memoryview) -> str:
    for field, _, value in _fields(buf):
        if field == 1:
            return bytes(value).decode()
    return ""


class OnnxModel:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            model = memoryview(fh.read())
        graph = None
        for field, _, value in _fields(model):
            if field == 7:
                graph = value
        if graph is None:
            raise ValueError("no graph in ONNX model")
        self.nodes = []
        self.initializers: dict[str, np.ndarray] = {}
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        for field, _, value in _fields(graph):
            if field == 1:
                self.nodes.append(_parse_node(value))
            elif field == 5:
                name, arr = _parse_tensor(value)
                self.initializers[name] = arr
            elif field == 11:
                self.inputs.append(_vi_name(value))
            elif field == 12:
                self.outputs.append(_vi_name(value))

    # -- ops ----------------------------------------------------------------

    @staticmethod
    def _conv(x, w, b, attrs):
        if attrs.get("dilations", [1, 1]) != [1, 1]:
            raise NotImplementedError(f"Conv dilations {attrs['dilations']}")
        if attrs.get("auto_pad") not in (None, "NOTSET", "SAME_UPPER"):
            # SAME_LOWER/VALID-with-pads would be silently miscomputed
            raise NotImplementedError(f"Conv auto_pad {attrs['auto_pad']}")
        stride = attrs.get("strides", [1, 1])
        group = attrs.get("group", 1)
        kh, kw = w.shape[2], w.shape[3]
        n, cin, h, wd = x.shape
        if attrs.get("auto_pad") == "SAME_UPPER":
            oh = -(-h // stride[0])
            ow = -(-wd // stride[1])
            ph = max((oh - 1) * stride[0] + kh - h, 0)
            pw = max((ow - 1) * stride[1] + kw - wd, 0)
            pads = (ph // 2, pw // 2, ph - ph // 2, pw - pw // 2)
        else:
            p = attrs.get("pads", [0, 0, 0, 0])
            pads = (p[0], p[1], p[2], p[3])
            oh = (h + p[0] + p[2] - kh) // stride[0] + 1
            ow = (wd + p[1] + p[3] - kw) // stride[1] + 1
        xp = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
        cout = w.shape[0]
        cig = cin // group  # input channels per group (w.shape[1])
        cog = cout // group
        out = np.zeros((n, cout, oh, ow), np.float32)
        for g in range(group):
            xg = xp[:, g * cig : (g + 1) * cig]
            wg = w[g * cog : (g + 1) * cog]  # (cog, cig, kh, kw)
            for ky in range(kh):
                for kx in range(kw):
                    patch = xg[:, :, ky : ky + oh * stride[0] : stride[0],
                               kx : kx + ow * stride[1] : stride[1]]
                    out[:, g * cog : (g + 1) * cog] += np.einsum(
                        "nchw,oc->nohw", patch, wg[:, :, ky, kx]
                    )
        if b is not None:
            out += b.reshape(1, -1, 1, 1)
        return out

    @staticmethod
    def _maxpool(x, attrs):
        # strict oracle: this implements VALID pooling only — reject the
        # attributes that would otherwise be silently ignored
        if attrs.get("auto_pad") not in (None, "NOTSET", "VALID"):
            raise NotImplementedError(f"MaxPool auto_pad {attrs['auto_pad']}")
        if any(attrs.get("pads", [])):
            raise NotImplementedError(f"MaxPool pads {attrs['pads']}")
        if attrs.get("ceil_mode", 0):
            raise NotImplementedError("MaxPool ceil_mode")
        if attrs.get("dilations", [1, 1]) not in ([1, 1], [1]):
            raise NotImplementedError(f"MaxPool dilations {attrs['dilations']}")
        kh, kw = attrs["kernel_shape"]
        sh, sw = attrs.get("strides", attrs["kernel_shape"])
        n, c, h, w = x.shape
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        out = np.full((n, c, oh, ow), -np.inf, np.float32)
        for ky in range(kh):
            for kx in range(kw):
                out = np.maximum(
                    out, x[:, :, ky : ky + oh * sh : sh, kx : kx + ow * sw : sw]
                )
        return out

    def run(self, feeds: dict) -> dict:
        env: dict[str, np.ndarray] = dict(self.initializers)
        for k, v in feeds.items():
            env[k] = np.asarray(v, np.float32)
        for op, inputs, outputs, attrs in self.nodes:
            a = [env[i] if i else None for i in inputs]
            if op == "Conv":
                r = self._conv(a[0], a[1], a[2] if len(a) > 2 else None, attrs)
            elif op == "BatchNormalization":
                x, scale, bias, mean, var = a
                eps = attrs.get("epsilon", 1e-5)
                shape = (1, -1) + (1,) * (x.ndim - 2)
                r = (x - mean.reshape(shape)) / np.sqrt(
                    var.reshape(shape) + eps
                ) * scale.reshape(shape) + bias.reshape(shape)
            elif op == "Clip":
                r = np.clip(a[0], a[1], a[2])
            elif op == "Relu":
                r = np.maximum(a[0], 0.0)
            elif op == "MaxPool":
                r = self._maxpool(a[0], attrs)
            elif op == "Transpose":
                r = np.transpose(a[0], attrs["perm"])
            elif op == "Flatten":
                r = a[0].reshape(a[0].shape[0], -1)
            elif op == "Gemm":
                # strict oracle: reject attribute values we would silently
                # miscompute (we never emit them)
                if (attrs.get("transA", 0) or attrs.get("transB", 0)
                        or attrs.get("alpha", 1.0) != 1.0
                        or attrs.get("beta", 1.0) != 1.0):
                    raise NotImplementedError(f"Gemm attrs {attrs}")
                r = a[0] @ a[1] + (a[2] if len(a) > 2 else 0.0)
            elif op == "Softmax":
                z = a[0] - a[0].max(axis=attrs.get("axis", -1), keepdims=True)
                e = np.exp(z)
                r = e / e.sum(axis=attrs.get("axis", -1), keepdims=True)
            elif op == "Slice":
                starts, ends, axes = a[1], a[2], a[3]
                if len(a) > 4 and a[4] is not None and any(
                        int(s) != 1 for s in np.atleast_1d(a[4])):
                    raise NotImplementedError(f"Slice steps {a[4]}")
                sl = [slice(None)] * a[0].ndim
                for s, e, ax in zip(starts, ends, axes):
                    sl[int(ax)] = slice(int(s), int(e))
                r = a[0][tuple(sl)]
            elif op == "Squeeze":
                r = np.squeeze(a[0], axis=tuple(int(i) for i in a[1]))
            elif op == "Add":
                r = a[0] + a[1]
            elif op == "Sub":
                r = a[0] - a[1]
            elif op == "Mul":
                r = a[0] * a[1]
            elif op == "Sigmoid":
                r = 1.0 / (1.0 + np.exp(-a[0]))
            elif op == "Tanh":
                r = np.tanh(a[0])
            else:
                raise NotImplementedError(f"op {op}")
            env[outputs[0]] = np.asarray(r, np.float32)
        return {name: env[name] for name in self.outputs}
