"""Model export: native checkpoint -> TF SavedModel / TFLite / frozen pb
(counterpart of `tpu_speech_commands/export/saved_model.py`; ONNX is
`onnx_writer.export_onnx_model`, which needs no TensorFlow).

The JAX package traces its flax forward with jax2tf.  The port builds the
reference-architecture tf.keras model (`keras_interop.build_keras_model`),
fills it with the checkpoint's weights as `export_keras_h5` does, and
saves it with the JAX export's serving contract:

    .npz checkpoint -> tf.keras model -> SavedModel (`serving_default`)
                                           |-> TFLiteConverter -> .tflite
                                           |-> frozen GraphDef  -> .pb

The signature takes `feature_input` (B, n_features, feature_size[, 1]),
batch-polymorphic unless a batch is fixed, and returns the softmax scores
`score_predict` (B, num_classes).  A params.json and classes.txt are
written beside the export for the on-device apps.  TensorFlow is imported
only by the functions that need it.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from ..models import input_shape, is_cnn
from ..params import pr
from .keras_interop import keras_model_from_checkpoint


def _write_saved_model(checkpoint_path: str, output_dir: str,
                       batch_size: int | None) -> dict:
    """The checkpoint's tf.keras model (without its training-only dropout)
    saved with the serving signature; returns the checkpoint's meta."""
    import keras
    import tensorflow as tf

    keras_model, meta = keras_model_from_checkpoint(checkpoint_path,
                                                    dropout=False)
    spec = tf.TensorSpec(
        (batch_size,) + input_shape(meta["model_type"], params=pr),
        tf.float32, name="feature_input")
    archive = keras.export.ExportArchive()
    archive.track(keras_model)
    archive.add_endpoint(
        "serving_default",
        lambda feature_input: {
            "score_predict": keras_model(feature_input, training=False)},
        input_signature=[spec])
    os.makedirs(output_dir, exist_ok=True)
    archive.write_out(output_dir, verbose=False)
    return meta


def export_saved_model(checkpoint_path: str, output_dir: str,
                       batch_size: int | None = None) -> str:
    """Native checkpoint -> TF SavedModel with a `serving_default`
    signature (batch-polymorphic unless `batch_size` is given)."""
    meta = _write_saved_model(checkpoint_path, output_dir, batch_size)
    _emit_sidecars(output_dir, meta.get("classes"))
    return output_dir


def export_tflite(checkpoint_path: str, output_file: str,
                  quantize: bool = False, representative_data=None) -> str:
    """Native checkpoint -> .tflite flat buffer (fixed batch 1).

    RNN models export their recurrence as TFLite control-flow ops
    (SELECT_TF_OPS enabled as a fallback).  quantize=True applies
    dynamic-range 8-bit weight quantization.  `representative_data`, an
    (N, n_features, feature_size) feature array, also calibrates the
    activations for full post-training quantization; I/O stays float.
    """
    import tensorflow as tf

    with tempfile.TemporaryDirectory() as tmp:
        meta = _write_saved_model(checkpoint_path, tmp, 1)
        converter = tf.lite.TFLiteConverter.from_saved_model(tmp)
        converter.target_spec.supported_ops = [
            tf.lite.OpsSet.TFLITE_BUILTINS,
            tf.lite.OpsSet.SELECT_TF_OPS,
        ]
        if quantize or representative_data is not None:
            converter.optimizations = [tf.lite.Optimize.DEFAULT]
        if representative_data is not None:
            samples = np.asarray(representative_data, np.float32)
            if is_cnn(meta["model_type"]) and samples.ndim == 3:
                samples = samples[..., None]
            elif not is_cnn(meta["model_type"]) and samples.ndim == 4:
                samples = samples[..., 0]

            def rep_gen():
                for row in samples:
                    yield [row[None, ...]]

            converter.representative_dataset = rep_gen
        blob = converter.convert()
    out_dir = os.path.dirname(os.path.abspath(output_file))
    os.makedirs(out_dir, exist_ok=True)
    with open(output_file, "wb") as f:
        f.write(blob)
    _emit_sidecars(out_dir, meta.get("classes"))
    return output_file


def export_frozen_pb(checkpoint_path: str, output_file: str,
                     output_nodes_prefix: str | None = None,
                     save_graph_def: bool = False) -> str:
    """Native checkpoint -> frozen TF GraphDef .pb (batch 1), the
    SavedModel's signature with its variables folded into constants.

    `output_nodes_prefix` appends Identity nodes `<prefix>0..<prefix>N-1`
    aliasing the graph outputs (the original nodes stay, so existing
    loaders keep working) and `save_graph_def` also writes an ascii
    `<stem>.pbtxt` next to the .pb.
    """
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    with tempfile.TemporaryDirectory() as tmp:
        _write_saved_model(checkpoint_path, tmp, 1)
        loaded = tf.saved_model.load(tmp)
        frozen = convert_variables_to_constants_v2(
            loaded.signatures["serving_default"])
        graph_def = frozen.graph.as_graph_def()
        if output_nodes_prefix:
            for i, tensor in enumerate(frozen.outputs):
                node = graph_def.node.add()
                node.op = "Identity"
                node.name = f"{output_nodes_prefix}{i}"
                node.input.append(tensor.name.split(":")[0])
                node.attr["T"].type = tensor.dtype.as_datatype_enum
    out_dir = os.path.dirname(os.path.abspath(output_file))
    os.makedirs(out_dir, exist_ok=True)
    tf.io.write_graph(graph_def, out_dir, os.path.basename(output_file),
                      as_text=False)
    if save_graph_def:
        stem = os.path.splitext(os.path.basename(output_file))[0]
        tf.io.write_graph(graph_def, out_dir, stem + ".pbtxt", as_text=True)
    return output_file


def _emit_sidecars(output_dir: str, classes) -> None:
    """params.json + classes.txt next to the exported model (read by the
    native C++ apps)."""
    with open(os.path.join(output_dir, "params.json"), "w") as f:
        json.dump(pr.to_dict(), f, indent=2)
    if classes:
        with open(os.path.join(output_dir, "classes.txt"), "w") as f:
            f.write("\n".join(classes) + "\n")
