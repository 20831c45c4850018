"""Batch serving: audio -> scores for a checkpoint (counterpart of
`tpu_speech_commands/serving.py::make_batch_scorer`).

On a CUDA device every path runs two hand-written kernels (one, where the
config takes the plain frontend route):

    (B, S) f32 | int16 audio, x gain
      -> MFCC frontend, by the route `frontend_route` picks for the config:
         FFT kernel    (ops/frontend_kernel.py, csrc/mfcc_frontend.cu),
                       n_fft a power of two ("cuda-mfcc");
         CT route      (ops/ct_kernel.py), the configs the JAX scorer runs
                       on its CT kernel, n_fft = 128 n2 (n2 even) = window,
                       not a power of two ("cuda-ct"): the mixed-radix FFT
                       (csrc/mixed_fft_frontend.cu) up to n_fft 4096, the
                       CT split's per-piece-mel instantiation above it
                       ("cuda-ct(split-dup)", csrc/ct_frontend.cu);
         plain chain   every other config, which the JAX scorer, too, runs
                       on plain XLA products ("torch(xla-route)")
      -> GRU classifier kernel   (ops/rnn_kernel.py, csrc/gru_classifier.cu),
         LSTM classifier kernel  (ops/rnn_kernel.py, csrc/lstm_classifier.cu)
         or CNN classifier kernel (ops/cnn_kernel.py, csrc/cnn_classifier.cu)
      -> softmax scores (B, C)

simple_lstm runs its kernel in float32 for either compute_dtype, with an
f32 feature handoff: the numerics of the JAX scorer, which keeps the LSTM
in f32.  (The JAX scorer runs it on the XLA scan because that was faster on
the TPU; on the card the plain loop is 30 steps of small launches.)  On the
CPU both stages run their plain PyTorch versions.  `.paths` records what
each stage runs.

    from tpu_speech_commands_torch.serving import make_batch_scorer
    scorer = make_batch_scorer("pretrained/direction_simple_gru.npz", "cuda")
    scores = scorer(audio_batch)          # (B, max_samples) -> (B, C)
"""
from __future__ import annotations

import torch

from .device import DEFAULT_DEVICE, resolve_device
from .export.inference_loader import load_native
from .models import is_cnn, score_fn
from .ops.cnn_kernel import CNNClassifier
from .ops.frontend_kernel import MfccFrontend
from .ops.rnn_kernel import GRUClassifier, LSTMClassifier
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


def make_classifier(model, model_type: str, compute_dtype=torch.float32):
    """(classifier, path) for a model on its device: the GRU, LSTM or CNN
    classifier wrapper in compute_dtype, which launches its kernel on CUDA
    features and runs the plain module on CPU ones; path names it
    ("cuda-gru", "cuda-lstm", "cuda-cnn", or "torch" for a model on the
    CPU).  The wrapper packs or lowers the weights once: a model whose
    weights change later needs a new one."""
    on_cuda = next(model.parameters()).is_cuda
    if model_type == "simple_gru":
        classifier, name = GRUClassifier(model, compute_dtype), "cuda-gru"
    elif is_cnn(model_type):
        classifier, name = CNNClassifier(model, compute_dtype), "cuda-cnn"
    else:
        classifier, name = LSTMClassifier(model, compute_dtype), "cuda-lstm"
    return classifier, name if on_cuda else "torch"


def make_batch_scorer(checkpoint_path: str, device=DEFAULT_DEVICE,
                      compute_dtype=torch.float32) -> BatchScorer:
    """Load a native `.npz` checkpoint onto `device` and build audio ->
    scores.

    compute_dtype=torch.bfloat16 runs the GRU or CNN kernel's matmuls on
    bf16 inputs with f32 accumulation, and the frontend kernel then hands
    its features over in bf16 (the classifier rounds them to bf16 anyway).
    The LSTM classifier stays in float32, as in the JAX package; its bf16
    mode is `ops.LSTMClassifier(model, torch.bfloat16)`.

    The device is the card unless the caller passes "cpu".  Raises
    RuntimeError for a CUDA device when CUDA is not available, and
    ValueError for a CUDA device when the frontend route's kernel cannot
    take the checkpoint's config; nothing falls back to the CPU.
    """
    device = resolve_device(device)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    predictor = load_native(checkpoint_path, device)
    feature_type = predictor.meta.get("feature_type", "mfcc")
    # snapshot NOW: load_native just put this checkpoint's params into the
    # global pr, and a later load must not rewire this scorer's frontend
    p = pr.replace()
    lstm = predictor.model_type == "simple_lstm"
    classifier, classifier_path = make_classifier(
        predictor.model, predictor.model_type,
        torch.float32 if lstm else compute_dtype)
    # bf16 feature handoff only into the GRU and CNN kernels, which round
    # their matmul inputs to bf16 anyway; the LSTM stays f32
    handoff = (compute_dtype if classifier_path in ("cuda-gru", "cuda-cnn")
               else torch.float32)
    frontend = MfccFrontend(p, feature_type, device, out_dtype=handoff)
    paths = {
        "frontend": frontend.path + ("(bf16-handoff)"
                                     if handoff != torch.float32 else ""),
        "classifier": classifier_path,
    }
    return BatchScorer(frontend, classifier, predictor, p, paths)
