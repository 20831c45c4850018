"""Export a native checkpoint to another model format (counterpart of
`tools/model_converter/export_model.py`, with the same flags).

    python -m tpu_speech_commands_torch.export_model \
        --checkpoint logs/000/trained_final.npz \
        --format onnx --output_path model.onnx

`native` (.tscm) and `onnx` need numpy only; `keras_h5`, `saved_model`,
`tflite` and `pb` need TensorFlow (and h5py for keras_h5).
"""
from __future__ import annotations

import argparse

import numpy as np

from .export.keras_interop import export_keras_h5
from .export.native_format import export_native
from .export.onnx_writer import export_onnx_model
from .export.saved_model import (export_frozen_pb, export_saved_model,
                                 export_tflite)
from .params import inject_params


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="native .npz checkpoint")
    parser.add_argument("--format", type=str, required=True,
                        choices=["saved_model", "tflite", "pb", "onnx",
                                 "keras_h5", "native"])
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--quantize", action="store_true",
                        help="8-bit weight quantization: TFLite dynamic-range"
                             " for --format tflite, symmetric per-channel"
                             " int8 kernels for --format native")
    parser.add_argument("--calibration_features", type=str, default=None,
                        help="npy/npz of (N, n_features, feature_size) "
                             "features for full int8 activation calibration "
                             "(MNN quantized.out analogue)")
    parser.add_argument("--output_nodes_prefix", type=str, default=None,
                        help="(--format pb) alias output nodes as "
                             "<prefix>0..N-1 via appended Identity nodes "
                             "(reference keras_to_tensorflow.py:99-111)")
    parser.add_argument("--save_graph_def", action="store_true",
                        help="(--format pb) also dump an ascii .pbtxt "
                             "next to the .pb")
    parser.add_argument("--params_path", type=str, default=None)
    return parser


def load_calibration(path: str) -> np.ndarray:
    """The calibration features of an .npy, or of an .npz's 'features'
    member or sole member; ValueError for an archive with several members
    and none named 'features' (an arbitrary one could be the labels)."""
    loaded = np.load(path)
    if not hasattr(loaded, "files"):
        return loaded
    if "features" in loaded.files:
        return loaded["features"]
    if len(loaded.files) == 1:
        return loaded[loaded.files[0]]
    raise ValueError(f"{path} has members {loaded.files}; save the "
                     "calibration set as a single array or under the key "
                     "'features'")


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    if args.params_path:
        inject_params(args.params_path)
    if args.format == "saved_model":
        out = export_saved_model(args.checkpoint, args.output_path)
    elif args.format == "tflite":
        rep = (load_calibration(args.calibration_features)
               if args.calibration_features else None)
        out = export_tflite(args.checkpoint, args.output_path, args.quantize,
                            representative_data=rep)
    elif args.format == "pb":
        out = export_frozen_pb(args.checkpoint, args.output_path,
                               output_nodes_prefix=args.output_nodes_prefix,
                               save_graph_def=args.save_graph_def)
    elif args.format == "keras_h5":
        out = export_keras_h5(args.checkpoint, args.output_path)
    elif args.format == "native":
        out = export_native(args.checkpoint, args.output_path,
                            quantize=args.quantize)
    else:
        out = export_onnx_model(args.checkpoint, args.output_path)
    print(f"Exported {args.format} to {out}")
    return out


if __name__ == "__main__":
    main()
