"""Native `.npz` checkpoint -> PyTorch model (counterpart of
`tpu_speech_commands/export/inference_loader.py::load_native`).

Only the native checkpoint is ported; the other formats of the JAX loader
(TFLite, Keras, ONNX, `.tscm`) wait for the export slice (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..checkpoints import load_checkpoint
from ..convert import torch_state_from_jax
from ..models import get_model, score_fn
from ..params import pr


class NativePredictor:
    """A loaded checkpoint: `.model` (eval mode, on `.device`),
    `.model_type`, `.num_classes`, `.classes`, `.meta`.  Calling it maps
    (B, n_features, feature_size) features to softmax scores (B, C)."""

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
        return score_fn(self.model(x))


def load_native(model_path: str, device="cpu") -> NativePredictor:
    """Load a native `.npz` checkpoint onto `device`.

    Like the JAX loader, the checkpoint's stored audio params are applied to
    the global `pr` (so the frontend built next matches the model), and
    every tensor is shape-checked against a freshly built model."""
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
    device = torch.device(device)
    model.to(device).eval()
    return NativePredictor(model, model_type, num_classes,
                           meta.get("classes"), meta, device)
