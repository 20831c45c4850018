"""Batch serving: audio -> scores for a checkpoint (counterpart of
`tpu_speech_commands/serving.py::make_batch_scorer`).

On a CUDA device the simple_gru path runs the two hand-written kernels:

    (B, S) f32 | int16 audio, x gain
      -> MFCC frontend kernel   (ops/frontend_kernel.py, csrc/mfcc_frontend.cu)
      -> GRU classifier kernel  (ops/rnn_kernel.py, csrc/gru_classifier.cu)
      -> softmax scores (B, C)

simple_lstm keeps its plain module loop for the classifier, as the JAX
package keeps the LSTM on the XLA scan.  On the CPU both stages run their
plain PyTorch versions.  `.paths` records what each stage runs.

    from tpu_speech_commands_torch.serving import make_batch_scorer
    scorer = make_batch_scorer("pretrained/direction_simple_gru.npz", "cuda")
    scores = scorer(audio_batch)          # (B, max_samples) -> (B, C)
"""
from __future__ import annotations

import torch

from .export.inference_loader import load_native
from .models import score_fn
from .ops.frontend_kernel import MfccFrontend
from .ops.rnn_kernel import GRUClassifier
from .params import pr


class BatchScorer:
    """(B, max_samples) float32 or int16 audio for any B [, scalar gain]
    -> (B, C) float32 softmax scores.  Attributes: `.classes`,
    `.num_classes`, `.model_type`, `.paths`, `.device`, `.params`."""

    def __init__(self, frontend, classifier, predictor, params, paths):
        self.frontend = frontend
        self.classifier = classifier
        self.classes = predictor.classes
        self.num_classes = predictor.num_classes
        self.model_type = predictor.model_type
        self.device = predictor.device
        self.params = params
        self.paths = paths

    @torch.inference_mode()
    def __call__(self, audio, gain=None) -> torch.Tensor:
        audio = torch.as_tensor(audio, device=self.device).contiguous()
        return score_fn(self.classifier(self.frontend(audio, gain)))


def make_batch_scorer(checkpoint_path: str, device="cpu",
                      compute_dtype=torch.float32) -> BatchScorer:
    """Load a native `.npz` checkpoint onto `device` and build audio ->
    scores.

    compute_dtype=torch.bfloat16 runs the GRU kernel's matmuls on bf16
    inputs with f32 accumulation, and the frontend kernel then hands its
    features over in bf16 (the classifier rounds them to bf16 anyway).  The
    LSTM classifier stays in float32, as in the JAX package.

    Raises RuntimeError for a CUDA device when CUDA is not available, and
    ValueError for a CUDA device when the frontend kernel cannot take the
    checkpoint's config; nothing falls back to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    predictor = load_native(checkpoint_path, device)
    feature_type = predictor.meta.get("feature_type", "mfcc")
    # snapshot NOW: load_native just put this checkpoint's params into the
    # global pr, and a later load must not rewire this scorer's frontend
    p = pr.replace()
    on_cuda = device.type == "cuda"

    model = predictor.model
    if predictor.model_type == "simple_gru":
        classifier = GRUClassifier(model, compute_dtype)
        classifier_path = "cuda-gru" if on_cuda else "torch"
    else:
        def classifier(feats):
            return model(feats.to(torch.float32))

        classifier_path = "torch"
    # bf16 feature handoff only into the kernel classifier, which rounds its
    # matmul inputs to bf16 anyway
    handoff = (compute_dtype if classifier_path == "cuda-gru"
               else torch.float32)
    frontend = MfccFrontend(p, feature_type, device, out_dtype=handoff)
    paths = {
        "frontend": ("cuda-mfcc" + ("(bf16-handoff)"
                                    if handoff != torch.float32 else ""))
        if on_cuda else "torch",
        "classifier": classifier_path,
    }
    return BatchScorer(frontend, classifier, predictor, p, paths)
