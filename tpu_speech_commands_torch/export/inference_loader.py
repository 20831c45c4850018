"""Native `.npz` checkpoint -> PyTorch model (counterpart of
`tpu_speech_commands/export/inference_loader.py::load_native`).

Only the native checkpoint is ported; the other formats of the JAX loader
(TFLite, Keras, ONNX, `.tscm`) wait for the export slice (ROADMAP.md):
`require_native` names them in a ValueError.  `resolve_feature_type` is the
checkpoint contract of the JAX package's `resolve_checkpoint_contract`,
shared by `eval`, `listen` and `stream_server`.
"""
from __future__ import annotations

import os

import torch

from ..checkpoints import load_checkpoint
from ..convert import torch_state_from_jax
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import features_to_input, get_model, score_fn
from ..params import pr


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


_EXTERNAL = ((".tflite", "TFLite"), (".h5", "Keras h5"), (".keras", "Keras"),
             (".onnx", "ONNX"), (".tscm", "native .tscm"), (".pb", "frozen pb"),
             (".mnn", "MNN"))


def external_format(model_path: str) -> str | None:
    """The name of a model format the port cannot load yet, or None for a
    native `.npz`."""
    if model_path.endswith(".npz"):
        return None
    for suffix, name in _EXTERNAL:
        if model_path.endswith(suffix):
            return name
    return "SavedModel" if os.path.isdir(model_path) else "unknown"


def require_native(model_path: str) -> None:
    """ValueError naming the format unless `model_path` is a native `.npz`
    checkpoint."""
    fmt = external_format(model_path)
    if fmt is not None:
        raise ValueError(
            f"{model_path}: the {fmt} format is not ported to "
            "tpu_speech_commands_torch yet (queued in ROADMAP.md); the port "
            "loads native .npz checkpoints")


def resolve_feature_type(meta: dict, num_classes: int, class_names,
                         feature_type: str | None, warn=print) -> str:
    """The checkpoint contract of the JAX package's
    `resolve_checkpoint_contract`: the feature type from the checkpoint
    unless the flag names one (a contradiction warns), and a class count
    that must match the model's head."""
    meta_ft = meta.get("feature_type")
    if feature_type is None:
        feature_type = meta_ft or "mfcc"
    elif meta_ft and feature_type != meta_ft:
        warn(f"WARNING: --feature_type {feature_type} overrides the "
             f"checkpoint's stored feature_type={meta_ft}; scores will be "
             "meaningless unless this is intentional.")
    if num_classes is not None and num_classes != len(class_names):
        raise ValueError(f"classes file has {len(class_names)} entries but the "
                         f"model predicts {num_classes} classes")
    stored = meta.get("classes")
    if stored and list(stored) != list(class_names):
        warn("WARNING: classes file differs from the checkpoint's stored "
             f"class list {list(stored)}; labels may be misattributed.")
    return feature_type
