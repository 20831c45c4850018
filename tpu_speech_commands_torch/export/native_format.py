"""Native deployment model format (.tscm), counterpart of
`tpu_speech_commands/export/native_format.py`: the same writer and reader,
byte for byte.

The layout, which the C++ runtime in `native/` reads:

    magic 'TSCM' | u32 version | u32 meta_len | meta JSON (utf-8)
    v1 record: u32 name_len | name | u32 ndim | u32 dims[ndim] | f32 data[]
    v2 record: u32 name_len | name | u32 ndim | u32 dims[ndim] | u8 dtype |
               dtype 0 -> f32 data[]
               dtype 1 -> u32 n_scales | f32 scales[] | i8 data[]
                          (symmetric int8, per-channel over the LAST axis)

meta JSON carries model_type, num_classes, class names and the audio
params: everything the on-device app needs besides the weights.

Quantization (`quantize=True`) stores every >=2-D kernel as symmetric
per-output-channel int8; the native runtime then runs dynamic-range int8
compute (activations quantized per tensor at each layer, int32
accumulation, native/model.cc).
"""
from __future__ import annotations

import json
import struct

import numpy as np

from ..checkpoints import load_checkpoint
from ..params import pr
from ..training.checkpoints import flatten_variables

MAGIC = b"TSCM"
VERSION = 2

DTYPE_F32 = 0
DTYPE_Q8 = 1  # symmetric int8, per-channel scales over the last axis


def quantize_symmetric_q8(arr: np.ndarray):
    """float32 (…, C) -> (int8 data, float32 per-last-axis scales)."""
    flat = arr.reshape(-1, arr.shape[-1]).astype(np.float32)
    amax = np.abs(flat).max(axis=0)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(flat / scales), -127, 127).astype(np.int8)
    return q.reshape(arr.shape), scales


def _should_quantize(name: str, arr: np.ndarray) -> bool:
    return arr.ndim >= 2 and name.endswith("kernel")


def write_native_model(output_file: str, flat_params: dict[str, np.ndarray],
                       meta: dict, quantize: bool = False) -> str:
    with open(output_file, "wb") as f:
        meta_blob = json.dumps(meta).encode()
        f.write(MAGIC)
        f.write(struct.pack("<II", VERSION, len(meta_blob)))
        f.write(meta_blob)
        for name in sorted(flat_params):
            arr = np.ascontiguousarray(flat_params[name], dtype=np.float32)
            name_b = name.encode()
            f.write(struct.pack("<I", len(name_b)))
            f.write(name_b)
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}I", *arr.shape))
            if quantize and _should_quantize(name, arr):
                q, scales = quantize_symmetric_q8(arr)
                f.write(struct.pack("<B", DTYPE_Q8))
                f.write(struct.pack("<I", scales.size))
                f.write(scales.tobytes())
                f.write(np.ascontiguousarray(q).tobytes())
            else:
                f.write(struct.pack("<B", DTYPE_F32))
                f.write(arr.tobytes())
    return output_file


def read_native_model(path: str, dequantize: bool = True):
    """Python-side reader (used by tests to validate the format).

    Quantized tensors come back dequantized to float32 by default; with
    dequantize=False they come back as (int8 data, float32 scales) tuples.
    """
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError("bad magic")
        version, meta_len = struct.unpack("<II", f.read(8))
        if version not in (1, VERSION):
            raise ValueError(f"unsupported version {version}")
        meta = json.loads(f.read(meta_len))
        tensors = {}
        while True:
            head = f.read(4)
            if not head:
                break
            (name_len,) = struct.unpack("<I", head)
            name = f.read(name_len).decode()
            (ndim,) = struct.unpack("<I", f.read(4))
            shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim))
            count = int(np.prod(shape)) if ndim else 1
            dtype = DTYPE_F32
            if version >= 2:
                (dtype,) = struct.unpack("<B", f.read(1))
            if dtype == DTYPE_F32:
                data = np.frombuffer(f.read(4 * count), "<f4").reshape(shape)
            elif dtype == DTYPE_Q8:
                (n_scales,) = struct.unpack("<I", f.read(4))
                scales = np.frombuffer(f.read(4 * n_scales), "<f4")
                q = np.frombuffer(f.read(count), np.int8).reshape(shape)
                data = (q.astype(np.float32) * scales if dequantize
                        else (q, scales))
            else:
                raise ValueError(f"unknown tensor dtype {dtype} in {path}")
            tensors[name] = data
    return tensors, meta


def export_native(checkpoint_path: str, output_file: str,
                  quantize: bool = False) -> str:
    """Native .npz checkpoint -> .tscm deployment blob.

    quantize=True stores the kernels as symmetric per-channel int8
    (~4x smaller blob; the native runtime executes them with
    dynamic-range int8 matmuls)."""
    variables, meta = load_checkpoint(checkpoint_path)
    flat = flatten_variables(variables)
    meta = {**meta}
    meta.setdefault("params", pr.to_dict())
    return write_native_model(output_file, flat, meta, quantize=quantize)
