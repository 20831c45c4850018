"""Multi-format inference model loader (counterpart of
`tpu_speech_commands/export/inference_loader.py`, with the same dispatch
and format names).

`load_inference_model(path)` dispatches on the file suffix and returns
``(predict, model_format)``:

- ``.npz``          native checkpoint -> `NativePredictor`, the PyTorch
                    model on the card (or "cpu"), torch scores (NATIVE)
- ``.pb``           frozen GraphDef -> TensorFlow (PB)
- ``.tflite``       TFLite flat buffer -> tf.lite.Interpreter (TFLITE)
- ``.h5``/``.keras``  Keras model (H5)
- SavedModel dir    its `serving_default` signature (SAVED_MODEL)
- ``.tscm``         deployment blob -> the C++ runtime in `native/` over
                    ctypes, built by the port with g++ (TSCM)
- ``.onnx``         onnxruntime when installed, else the numpy executor
                    `onnx_runtime_mini` (ONNX)
- ``.mnn``          ImportError: the MNN python runtime is not shipped

Every format but NATIVE runs on the host: its `predict` maps a numpy
(B, n_features, feature_size[, 1]) float32 batch to numpy (B, num_classes)
softmax scores, the input's rank adapted to the model's (`adapt_rank`).
TensorFlow, h5py and onnxruntime are imported only by the loaders that
need them.  `resolve_checkpoint_contract` is the entry points' shared
checkpoint contract; `resolve_feature_type` is its native case.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..checkpoints import load_checkpoint
from ..convert import torch_state_from_jax
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import features_to_input, get_model, score_fn
from ..native_binding import NativeModel
from ..params import pr
from .onnx_runtime_mini import OnnxModel


def resolve_checkpoint_contract(predict_fn, model_format: str,
                                class_names=None, feature_type=None,
                                warn=print) -> str:
    """The entry points' shared contract (eval / listen / stream_server):
    for a native checkpoint, `resolve_feature_type` on its metadata (the
    stored feature type unless the flag names one, a class count that must
    match the head).  Only native checkpoints carry metadata; an external
    format takes the flag, else mfcc."""
    if model_format != "NATIVE":
        return feature_type or "mfcc"
    return resolve_feature_type(predict_fn.meta, predict_fn.num_classes,
                                class_names, feature_type, warn)


def resolve_feature_type(meta: dict, num_classes: int, class_names,
                         feature_type: str | None, warn=print) -> str:
    """The checkpoint contract of the JAX package's
    `resolve_checkpoint_contract`: the feature type from the checkpoint
    unless the flag names one (a contradiction warns), and a class count
    that must match the model's head (not checked without class_names)."""
    meta_ft = meta.get("feature_type")
    if feature_type is None:
        feature_type = meta_ft or "mfcc"
    elif meta_ft and feature_type != meta_ft:
        warn(f"WARNING: --feature_type {feature_type} overrides the "
             f"checkpoint's stored feature_type={meta_ft}; scores will be "
             "meaningless unless this is intentional.")
    if class_names is None:
        return feature_type
    if num_classes is not None and num_classes != len(class_names):
        raise ValueError(f"classes file has {len(class_names)} entries but the "
                         f"model predicts {num_classes} classes")
    stored = meta.get("classes")
    if stored and list(stored) != list(class_names):
        warn("WARNING: classes file differs from the checkpoint's stored "
             f"class list {list(stored)}; labels may be misattributed.")
    return feature_type


def adapt_rank(features: np.ndarray, want_rank: int) -> np.ndarray:
    """`features` as float32 at `want_rank`: (N, T, F, 1) is rank 4 (a
    CNN's input), (N, T, F) rank 3 (an RNN's), the channel axis added or
    dropped."""
    features = np.asarray(features, np.float32)
    if features.ndim == want_rank + 1 and features.shape[-1] == 1:
        return features[..., 0]
    if features.ndim == want_rank - 1:
        return features[..., None]
    return features


class NativePredictor:
    """A loaded checkpoint: `.model` (eval mode, on `.device`),
    `.model_type`, `.num_classes`, `.classes`, `.meta`.  Calling it maps
    (B, n_features, feature_size[, 1]) features to softmax scores (B, C)."""

    def __init__(self, model, model_type, num_classes, classes, meta, device):
        self.model = model
        self.model_type = model_type
        self.num_classes = num_classes
        self.classes = classes
        self.meta = meta
        self.device = device

    @torch.inference_mode()
    def __call__(self, features) -> torch.Tensor:
        x = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        return score_fn(self.model(features_to_input(x, self.model_type)))


def load_native(model_path: str, device=DEFAULT_DEVICE) -> NativePredictor:
    """Load a native `.npz` checkpoint onto `device` (the card unless the
    caller passes "cpu"; RuntimeError for CUDA without CUDA).

    Like the JAX loader, the checkpoint's stored audio params are applied to
    the port's global `pr` (so the frontend built next matches the model),
    and every tensor is shape-checked against a freshly built model."""
    device = resolve_device(device)
    variables, meta = load_checkpoint(model_path)
    model_type = meta.get("model_type")
    num_classes = meta.get("num_classes")
    if model_type is None or num_classes is None:
        raise ValueError(
            f"{model_path} lacks model_type/num_classes metadata"
        )
    if meta.get("params"):
        pr.override(meta["params"])
    model = get_model(model_type, num_classes,
                      num_layers=int(meta.get("num_layers", 1)))
    state = torch_state_from_jax(variables, model_type)
    want = model.state_dict()
    if set(state) != set(want):
        raise ValueError(
            f"checkpoint tensors {sorted(set(state) ^ set(want))} do not "
            f"match the {model_type} model"
        )
    for key, value in state.items():
        if value.shape != want[key].shape:
            raise ValueError(
                f"checkpoint tensor {key} shape {tuple(value.shape)} != "
                f"model {tuple(want[key].shape)}"
            )
    model.load_state_dict(state)
    model.to(device).eval()
    return NativePredictor(model, model_type, num_classes,
                           meta.get("classes"), meta, device)


def load_tflite(model_path: str):
    from tensorflow.lite.python import interpreter as interpreter_wrapper

    interp = interpreter_wrapper.Interpreter(model_path=model_path)
    input_details = interp.get_input_details()
    output_details = interp.get_output_details()
    in_rank = len(input_details[0]["shape"])

    allocated_shape = [None]

    def predict(features):
        feats = adapt_rank(features, in_rank)
        outs = []
        for row in feats:  # TFLite interpreters are batch-1 by default
            shape = (1,) + row.shape
            if allocated_shape[0] != shape:  # streaming calls reuse tensors
                interp.resize_tensor_input(input_details[0]["index"], shape)
                interp.allocate_tensors()
                allocated_shape[0] = shape
            interp.set_tensor(input_details[0]["index"], row[None])
            interp.invoke()
            outs.append(interp.get_tensor(output_details[0]["index"])[0])
        return np.stack(outs)

    return predict


def load_keras(model_path: str):
    import tensorflow as tf

    model = tf.keras.models.load_model(model_path, compile=False)
    in_rank = len(model.inputs[0].shape)

    def predict(features):
        feats = adapt_rank(features, in_rank)
        return np.asarray(model(feats))

    predict.keras_model = model
    return predict


def load_saved_model(model_path: str):
    import tensorflow as tf

    loaded = tf.saved_model.load(model_path)
    fn = loaded.signatures["serving_default"]
    in_name, spec = next(iter(fn.structured_input_signature[1].items()))
    in_rank = len(spec.shape)

    def predict(features):
        feats = adapt_rank(features, in_rank)
        out = fn(**{in_name: tf.constant(feats)})
        return np.asarray(next(iter(out.values())))

    return predict


def load_frozen_pb(model_path: str):
    """Frozen GraphDef .pb (reference PB path, eval.py:40-60 equivalent;
    input/output tensors located by shape/type rather than hardcoded
    names)."""
    import tensorflow as tf

    graph_def = tf.compat.v1.GraphDef()
    with open(model_path, "rb") as f:
        graph_def.ParseFromString(f.read())

    def wrapped(*inputs):
        return tf.graph_util.import_graph_def(graph_def, name="")

    placeholders = [n for n in graph_def.node if n.op == "Placeholder"]
    # output = the last Identity/PartitionedCall NODE (by op, not name —
    # TF2 freezes emit 'Identity_1' / 'StatefulPartitionedCall' etc., and
    # a name match would fall through to graph_def.node[-1], which can be
    # a NoOp/const that prunes the wrong tensor)
    outputs = [n.name for n in graph_def.node
               if n.op in ("Identity", "PartitionedCall",
                           "StatefulPartitionedCall")]
    in_name = placeholders[0].name + ":0"
    out_name = (outputs[-1] if outputs else graph_def.node[-1].name) + ":0"
    fn = tf.compat.v1.wrap_function(wrapped, [])
    concrete = fn.prune(in_name, out_name)
    in_rank = len(concrete.inputs[0].shape)

    def predict(features):
        feats = adapt_rank(features, in_rank)
        outs = [np.asarray(concrete(tf.constant(row[None])))[0] for row in feats]
        return np.stack(outs)

    return predict


def load_inference_model(model_path: str, device=DEFAULT_DEVICE):
    """Returns (predict_fn, model_format).  A native checkpoint loads onto
    `device` (the card unless the caller passes "cpu"); every other format
    runs on the host."""
    if model_path.endswith(".npz"):
        return load_native(model_path, device), "NATIVE"
    if model_path.endswith(".pb"):
        return load_frozen_pb(model_path), "PB"
    if model_path.endswith(".tflite"):
        return load_tflite(model_path), "TFLITE"
    if model_path.endswith((".h5", ".keras")):
        return load_keras(model_path), "H5"
    if os.path.isdir(model_path):
        return load_saved_model(model_path), "SAVED_MODEL"
    if model_path.endswith(".tscm"):
        # the on-device deployment blob, executed by the C++ runtime over
        # ctypes: eval and listen check the exact artifact that ships
        return _load_tscm(model_path), "TSCM"
    if model_path.endswith(".onnx"):
        try:
            import onnxruntime  # noqa: F401
        except ImportError:
            # built-in numpy executor (covers the graphs onnx_writer emits)
            return _load_onnx_mini(model_path), "ONNX"
        return _load_onnx(model_path), "ONNX"
    if model_path.endswith(".mnn"):
        raise ImportError(
            "MNN python runtime is not installed; use the native C++ apps under "
            "native/ or the .npz/.tflite paths"
        )
    raise ValueError(f"invalid model file: {model_path}")


def _load_tscm(model_path: str):
    native = NativeModel(model_path)

    def predict(features):
        feats = adapt_rank(features, 3)  # (B, n_features, width)
        return np.stack([native.predict(f) for f in feats])

    return predict


def _load_onnx_mini(model_path: str):
    model = OnnxModel(model_path)
    input_name = model.inputs[0]
    # rank from the first Transpose/Slice consumer is ambiguous; infer from
    # the graph: CNN exports start with a Transpose to NCHW (rank 4)
    in_rank = 4 if model.nodes and model.nodes[0][0] == "Transpose" else 3

    def predict(features):
        feats = adapt_rank(features, in_rank)
        return model.run({input_name: feats})["score_predict"]

    return predict


def _load_onnx(model_path: str):
    import onnxruntime

    session = onnxruntime.InferenceSession(
        model_path, providers=["CPUExecutionProvider"]
    )
    inp = session.get_inputs()[0]
    in_rank = len(inp.shape)

    def predict(features):
        feats = adapt_rank(features, in_rank)
        if in_rank == 4 and inp.shape[1] in (1,):  # NCHW export
            feats = np.transpose(feats, (0, 3, 1, 2))
        return session.run(None, {inp.name: feats})[0]

    return predict
