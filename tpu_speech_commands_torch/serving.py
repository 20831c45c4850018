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
                       (csrc/mixed_fft_frontend.cu) up to n_fft 4096, its
                       wide form above it ("cuda-ct(wide)",
                       csrc/wide_fft_frontend_*.cu), the CT split's
                       per-piece-mel instantiation where that block does
                       not fit ("cuda-ct(split-dup)", csrc/ct_frontend.cu);
         plain chain   every other config, which the JAX scorer, too, runs
                       on plain XLA products ("torch(xla-route)")
      -> GRU classifier kernel   (ops/rnn_kernel.py, csrc/gru_classifier.cu),
         LSTM classifier kernel  (ops/rnn_kernel.py, csrc/lstm_classifier.cu)
         or CNN classifier kernel (ops/cnn_kernel.py, csrc/cnn_classifier.cu)
      -> softmax scores (B, C)

With `mesh=` (a `parallel.Mesh`) the batch splits over the mesh's batch
axes: each shard's frontend and classifier kernels run on its device, from
a copy of the weights and the kernel constants there, on that device's
current stream with no host sync between shards: the inputs are copied
to every device first, and the scores gathered on the first device last
(the JAX scorer's collective-free `shard_map`; `.paths["parallel"]` is
"shards x<n>").

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

import copy

import torch

from .device import DEFAULT_DEVICE, resolve_device
from .export.inference_loader import load_native
from .models import is_cnn, score_fn
from .ops.cnn_kernel import CNNClassifier
from .ops.frontend_kernel import MfccFrontend
from .ops.rnn_kernel import GRUClassifier, LSTMClassifier
from .params import pr
from .parallel import batch_shards


def split_rows(x: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """x's rows in n equal blocks, one a batch shard; ValueError (the JAX
    scorer's) when they do not divide."""
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by the "
                         f"{n}-device data axis")
    return x.tensor_split(n)


def scatter(tensors: list, devices: list) -> list:
    """Each tensor (or None / a number, kept) on its shard's device, before
    any shard's work is launched: a copy between cards makes the streams of
    both wait for each other, and between launches it would run the shards
    one after another."""
    return [t.to(d) if isinstance(t, torch.Tensor) else t
            for t, d in zip(tensors, devices)]


def gather(outs: list, device) -> torch.Tensor:
    """Concatenate the shards' outputs on `device`, once every shard's work
    is launched (as `scatter`, for the same reason)."""
    return torch.cat([out.to(device) for out in outs])


class ShardedClassifier:
    """A classifier wrapper per batch shard, each on its device: (B, ...)
    features -> (B, C) logits, row block i through shards[i] on its device,
    gathered on the first shard's device (`.device`)."""

    def __init__(self, shards: list):
        self.shards = shards
        self.device = shards[0].device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        parts = scatter(split_rows(x, len(self.shards)),
                        [c.device for c in self.shards])
        return gather([c(part) for c, part in zip(self.shards, parts)],
                      self.device)


def shard_classifier(classifier, mesh) -> ShardedClassifier:
    """`classifier` (a `make_classifier` wrapper) on every batch shard of
    `mesh` (a `parallel.Mesh`): a copy of its model and packed weights on
    each other device, one wrapper a device shared by its shards."""
    by_device = {classifier.device: classifier}
    for device in mesh.batch_devices():
        device = torch.device(device)
        if device not in by_device:
            model = copy.deepcopy(classifier.model).to(device)
            by_device[device] = type(classifier)(model,
                                                 classifier.compute_dtype)
    return ShardedClassifier([by_device[torch.device(d)]
                              for d in mesh.batch_devices()])


class BatchScorer:
    """(B, max_samples) float32 or int16 audio for any B (a multiple of the
    shards on a mesh; or there a list of one block of rows a shard, each
    already on its shard's device) [, scalar gain] -> (B, C) float32
    softmax scores.
    Attributes: `.classes`, `.num_classes`, `.model_type`, `.paths`,
    `.device` (the first shard's, where the scores land), `.params`,
    `.shards` ((frontend, classifier) a batch shard), `.frontend` and
    `.classifier` (the first shard's)."""

    def __init__(self, shards, predictor, params, paths):
        self.shards = shards
        self.frontend, self.classifier = shards[0]
        self.classes = predictor.classes
        self.num_classes = predictor.num_classes
        self.model_type = predictor.model_type
        self.device = predictor.device
        self.params = params
        self.paths = paths

    @torch.inference_mode()
    def __call__(self, audio, gain=None) -> torch.Tensor:
        if len(self.shards) == 1:
            audio = torch.as_tensor(audio, device=self.device).contiguous()
            return score_fn(self.classifier(self.frontend(audio, gain)))
        parts = audio if isinstance(audio, (list, tuple)) else \
            split_rows(torch.as_tensor(audio), len(self.shards))
        devices = [classifier.device for _, classifier in self.shards]
        parts = scatter(parts, devices)
        gains = scatter([gain] * len(devices), devices)
        return gather([
            score_fn(classifier(frontend(part.contiguous(), g)))
            for (frontend, classifier), part, g in zip(self.shards, parts,
                                                       gains)],
            self.device)


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
                      compute_dtype=torch.float32, mesh=None) -> BatchScorer:
    """Load a native `.npz` checkpoint onto `device` and build audio ->
    scores; with `mesh` (a `parallel.Mesh`), onto each of its batch
    shards' devices instead (the first shard's is `.device`), the batch
    split over them.

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
    if mesh is not None:
        device = mesh.batch_devices()[0]
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
    shards = [(frontend, classifier)]
    n = batch_shards(mesh)
    if n > 1:
        classifiers = shard_classifier(classifier, mesh).shards
        frontends = {classifier.device: frontend}
        for c in classifiers:
            if c.device not in frontends:
                frontends[c.device] = MfccFrontend(p, feature_type, c.device,
                                                   out_dtype=handoff)
        shards = [(frontends[c.device], c) for c in classifiers]
        paths["parallel"] = f"shards x{n}"
    return BatchScorer(shards, predictor, p, paths)
