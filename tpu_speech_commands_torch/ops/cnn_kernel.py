"""The CNN kernels: wrappers, launch counts and plain versions.

`csrc/cnn_classifier.cu` holds three entry points and `csrc/cnn_block1.cu`
a fourth:
- `tsc_cnn_classifier` replaces the TPU kernel
  `tpu_speech_commands/ops/pallas_classifier.py::make_fused_cnn_classifier`:
  SimpleCNN / SimpleCNNLite features -> logits in one launch (four conv
  blocks, the relu6 dense layer and the head), each conv and the dense
  layer a tiled implicit GEMM with its weights staged through shared memory,
  on the tensor cores in bf16 (`ops/cnn_plan.py` is its plan);
- `tsc_cnn_classifier_simt`, the earlier design of the same function (a
  thread a (window, position, 4 channels), weights from L2), kept for the
  A/B: `cnn_classifier_cuda(..., _simt=True)`, counted in `SIMT.launches`;
- `tsc_cnn_block1` (`csrc/cnn_block1.cu`) replaces `tpu_speech_commands/
  ops/pallas_cnn.py::make_fused_conv_block1`: block 1 alone (conv, 2x2
  pool, +bias, relu6), which `make_fused_cnn_forward` feeds into the rest of
  the model; a persistent kernel fed by a TMA input ring, two pooled
  positions a lane, all 16 channels each (`ops/block1_plan.py` is its
  plan);
- `tsc_cnn_block1_simt`, the earlier design of block 1 (the SIMT kernel's
  conv-stage routine), kept for the A/B (`cnn_block1_cuda(..., _simt=True)`,
  counted in `BLOCK1_SIMT.launches`) and for a window whose ring does not fit
  the new kernel's shared memory (`block1_plan.kernel_for`, chosen from the
  config before any launch).

All run on constants lowered on the host (`ops/cnn_lowering.py`).
compute_dtype=torch.bfloat16 is the TPU kernels' bf16 mode: the matmul
weights are rounded to bf16 once, here, after BatchNorm folding and the
separable composition; every conv and dense input activation is rounded to
bf16; sums and epilogue constants stay float32.

The dispatchers (`CNNClassifier`, `make_fused_conv_block1`,
`make_fused_cnn_forward`) run the plain version for a CPU tensor and launch
the kernel for a CUDA tensor, or raise.  The plain versions compute on the
same lowered constants with `F.pad`, `F.conv2d` and `F.max_pool2d`, with
cuDNN's TF32 off, so that their float32 convs are float32.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.cnn import SimpleCNN, relu6
from ..models.rnn import _rounded
from . import _build, block1_plan
from .cnn_lowering import Lowered, Stage, lower_block1, lower_classifier
from .cnn_plan import Plan, make_plan
from .launch_count import LaunchCount

SOURCE = "tpu_speech_commands_torch/csrc/cnn_classifier.cu"
BLOCK1_SOURCE = "tpu_speech_commands_torch/csrc/cnn_block1.cu"
REPLACES = "tpu_speech_commands/ops/pallas_classifier.py:363"
BLOCK1_REPLACES = "tpu_speech_commands/ops/pallas_cnn.py:156"

# tsc_cnn_classifier(x, x_bf16, batch, stage_ptrs, stage_dims, plan,
#   dense_w, dense_b, head_w, head_b, hidden, classes, logits, bf16_math,
#   stream)
_N_ARGS = 15
_INT_ARGS = (1, 2, 10, 11, 13)
# tsc_cnn_classifier_simt(x, x_bf16, batch, n_stages, stage_ptrs, stage_dims,
#   dense_w, dense_b, head_w, head_b, hidden, classes, logits, bf16_math,
#   stream)
_SIMT_INT_ARGS = (1, 2, 3, 10, 11, 13)
# tsc_cnn_block1 and tsc_cnn_block1_simt(x, x_bf16, batch, w, bias, dims,
#   out, bf16_math, stream)
_BLOCK1_N_ARGS = 9
_BLOCK1_INT_ARGS = (1, 2, 7)
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")


def _tensor(arr: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    # row-major first: torch.tensor keeps a numpy view's strides
    return torch.tensor(np.ascontiguousarray(arr, np.float32),
                        device=device).to(dtype)


class StageTensors:
    """One lowered conv block on a device: its kernel in the compute dtype,
    its epilogue constants in float32."""

    def __init__(self, stage: Stage, device, compute_dtype=torch.float32):
        _check_compute_dtype(compute_dtype)
        self.stage = stage
        self.compute_dtype = compute_dtype
        self.kernel = _tensor(stage.kernel, device, compute_dtype)
        self.bias = _tensor(stage.bias, device)
        self.pre_bias = (None if stage.pre_bias is None
                         else _tensor(stage.pre_bias, device))
        self.mult = None if stage.mult is None else _tensor(stage.mult, device)
        self.device = self.kernel.device  # with its index: cuda -> cuda:0

    def dims(self) -> list[int]:
        """h_in, w_in, cin, cout, stride, pool, pad_h, pad_w: the kernel's
        description of the stage (pad_* is the low side)."""
        st = self.stage
        (pad_h, _), (pad_w, _) = st.pads
        return [st.h_in, st.w_in, st.cin, st.cout, st.stride, int(st.pool),
                pad_h, pad_w]

    def tensors(self) -> list[torch.Tensor | None]:
        return [self.kernel, self.bias, self.pre_bias, self.mult]


class ClassifierTensors:
    """A lowered classifier on a device: conv kernels and dense weights in
    the compute dtype, epilogue constants in float32."""

    def __init__(self, lowered: Lowered, device, compute_dtype=torch.float32):
        self.lowered = lowered
        self.stages = [StageTensors(st, device, compute_dtype)
                       for st in lowered.stages]
        self.compute_dtype = compute_dtype
        self.dense_w = _tensor(lowered.dense_w, device, compute_dtype)
        self.dense_b = _tensor(lowered.dense_b, device)
        self.head_w = _tensor(lowered.head_w, device, compute_dtype)
        self.head_b = _tensor(lowered.head_b, device)
        self.device = self.dense_w.device
        self._plan = None

    @property
    def plan(self) -> Plan:
        """The GEMM kernel's plan, at the largest tile that fits; ValueError
        for a config it cannot take (made at first use: the plain versions
        take every config)."""
        if self._plan is None:
            self._plan = make_plan(self.lowered.stages, self.dense_w.shape[1],
                                   self.compute_dtype)
        return self._plan

    @property
    def input_shape(self) -> tuple[int, int]:
        return self.stages[0].stage.h_in, self.stages[0].stage.w_in


def _check_constant(name: str, t: torch.Tensor, device) -> None:
    # the kernel reads 4 weights at a time: 16-byte loads in f32
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: need a contiguous, 16-byte aligned tensor on "
                         f"{device}, got one on {t.device}")


def _check_features(x: torch.Tensor, device, shape: tuple[int, int]) -> None:
    if x.device != device:
        raise ValueError(f"x must be on {device}, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or tuple(x.shape[1:]) != shape or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, {shape[0]}, {shape[1]}) "
                         f"tensor, got {tuple(x.shape)}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cnn_classifier_cuda(x: torch.Tensor, consts: ClassifierTensors,
                        _simt: bool = False) -> torch.Tensor:
    """Launch the classifier kernel.  x (B, H, W) float32 or bfloat16 on
    consts' CUDA device -> logits (B, C) float32.  The tiled implicit GEMM
    (ValueError for a config its plan cannot take) adds one to `.launches`;
    `_simt` runs the earlier SIMT kernel instead, for the A/B, and adds one
    to `SIMT.launches`."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check_features(x, consts.device, consts.input_shape)
    for i, st in enumerate(consts.stages):
        for name, t in zip(("kernel", "bias", "pre_bias", "mult"), st.tensors()):
            if t is not None:
                _check_constant(f"stage {i} {name}", t, consts.device)
    for name in ("dense_w", "dense_b", "head_w", "head_b"):
        _check_constant(name, getattr(consts, name), consts.device)
    batch = x.shape[0]
    # ValueError for a config the GEMM kernel cannot take, at any batch
    plan = None if _simt else consts.plan
    hidden, classes = consts.head_w.shape
    out = torch.empty((batch, classes), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    n = len(consts.stages)
    dims = (ctypes.c_int * (8 * n))(*[d for st in consts.stages
                                      for d in st.dims()])
    # an HWIO kernel is, as memory, the (9 cin, cout) K-major matrix the
    # GEMM kernel's products read
    ptrs = (ctypes.c_void_p * (4 * n))(*[
        None if t is None else t.data_ptr()
        for st in consts.stages for t in st.tensors()])
    consts_args = (consts.dense_w.data_ptr(), consts.dense_b.data_ptr(),
                   consts.head_w.data_ptr(), consts.head_b.data_ptr(), hidden,
                   classes, out.data_ptr(),
                   int(consts.compute_dtype == torch.bfloat16),
                   _stream(x.device))
    x_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        if _simt:
            name = "tsc_cnn_classifier_simt"
            fn = _build.bind(name, _N_ARGS, _SIMT_INT_ARGS)
            rc = fn(x.data_ptr(), x_bf16, batch, n, ptrs, dims, *consts_args)
        else:
            name = "tsc_cnn_classifier"
            ints = plan.ints()
            fn = _build.bind(name, _N_ARGS, _INT_ARGS)
            rc = fn(x.data_ptr(), x_bf16, batch, ptrs, dims,
                    (ctypes.c_int * len(ints))(*ints), *consts_args)
    _build.check(rc, name)
    if _simt:
        SIMT.launches += 1
    else:
        cnn_classifier_cuda.launches += 1
    return out


cnn_classifier_cuda.launches = 0
SIMT = LaunchCount()  # launches of the SIMT classifier kernel


def block1_kernel_for(stage: StageTensors, x_dtype) -> str:
    """The kernel `cnn_block1_cuda` launches for this stage and feature
    dtype, chosen from the config: "cnn_block1" where the new kernel's ring
    fits a block's shared memory, else "cnn_block1_simt"."""
    st = stage.stage
    return block1_plan.kernel_for(st.h_in, st.w_in,
                                  2 if x_dtype == torch.bfloat16 else 4)


def cnn_block1_cuda(x: torch.Tensor, stage: StageTensors,
                    _simt: bool = False) -> torch.Tensor:
    """Launch the block-1 kernel.  x (B, H, W) float32 or bfloat16 on the
    stage's CUDA device -> (B, H//2, W//2, C) float32 NHWC.  The new kernel
    (`tsc_cnn_block1`) adds one to `.launches`; the SIMT kernel, for a
    window `block1_kernel_for` sends there or with `_simt=True` (the A/B),
    adds one to `BLOCK1_SIMT.launches`."""
    st = stage.stage
    if st.cin != 1 or not st.pool or st.inline_relu:
        raise ValueError("the block-1 kernel takes one input channel, a pool "
                         "and no inline relu")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check_features(x, stage.device, (st.h_in, st.w_in))
    _check_constant("kernel", stage.kernel, stage.device)
    _check_constant("bias", stage.bias, stage.device)
    batch = x.shape[0]
    out = torch.empty((batch, st.h_out, st.w_out, st.cout),
                      dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    name = ("cnn_block1_simt" if _simt
            else block1_kernel_for(stage, x.dtype))
    fn = _build.bind("tsc_" + name, _BLOCK1_N_ARGS, _BLOCK1_INT_ARGS)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), batch,
                stage.kernel.data_ptr(), stage.bias.data_ptr(),
                (ctypes.c_int * 8)(*stage.dims()), out.data_ptr(),
                int(stage.compute_dtype == torch.bfloat16), _stream(x.device))
    _build.check(rc, "tsc_" + name)
    if name == "cnn_block1_simt":
        BLOCK1_SIMT.launches += 1
    else:
        cnn_block1_cuda.launches += 1
    return out


cnn_block1_cuda.launches = 0
BLOCK1_SIMT = LaunchCount()  # launches of the SIMT block-1 kernel


@contextlib.contextmanager
def _cudnn_tf32_off():
    """A float32 conv through cuDNN runs in TF32 unless this is off."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _stage_plain(stage: StageTensors, a: torch.Tensor) -> torch.Tensor:
    """One lowered stage on an NCHW float32 tensor (already rounded to the
    compute dtype) -> NCHW float32, not rounded."""
    st = stage.stage
    (top, bottom), (left, right) = st.pads
    w = stage.kernel.to(torch.float32).permute(3, 2, 0, 1)
    z = F.conv2d(F.pad(a, (left, right, top, bottom)), w, stride=st.stride)
    if st.inline_relu:
        z = torch.relu(z + stage.pre_bias[:, None, None])
        z = relu6(z * stage.mult[:, None, None] + stage.bias[:, None, None])
        return F.max_pool2d(z, 2, 2) if st.pool else z
    if st.pool:
        z = F.max_pool2d(z, 2, 2)
    return relu6(z + stage.bias[:, None, None])


def cnn_classifier_plain(consts: ClassifierTensors,
                         x: torch.Tensor) -> torch.Tensor:
    """The classifier kernel's plain version: (B, H, W) -> (B, C) float32
    logits, in the compute dtype of `consts`."""
    cd = consts.compute_dtype
    a = _rounded(x.to(torch.float32), cd)[:, None]
    with _cudnn_tf32_off():
        for stage in consts.stages:
            a = _rounded(_stage_plain(stage, a), cd)
    flat = a.permute(0, 2, 3, 1).flatten(1)  # NHWC (y, x, c) order
    hidden = relu6(flat @ consts.dense_w.to(torch.float32) + consts.dense_b)
    return _rounded(hidden, cd) @ consts.head_w.to(torch.float32) + consts.head_b


def cnn_block1_plain(stage: StageTensors, x: torch.Tensor) -> torch.Tensor:
    """The block-1 kernel's plain version: (B, H, W) -> (B, H//2, W//2, C)
    float32 NHWC."""
    a = _rounded(x.to(torch.float32), stage.compute_dtype)[:, None]
    with _cudnn_tf32_off():
        return _stage_plain(stage, a).permute(0, 2, 3, 1).contiguous()


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _squeeze_channel(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.ndim == 4 and x.shape[-1] == 1 else x


class CNNClassifier:
    """(B, H, W[, 1]) features -> (B, C) float32 logits of a SimpleCNN or
    SimpleCNNLite, lowered once on the model's device.  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""

    def __init__(self, model: SimpleCNN, compute_dtype=torch.float32):
        if not isinstance(model, SimpleCNN):
            raise TypeError(f"need a SimpleCNN, got {type(model).__name__}")
        lowered = lower_classifier(model.variables(), model.separable,
                                   model.n_features, model.feature_size)
        self.model = model
        self.compute_dtype = compute_dtype
        self.device = _model_device(model)
        self.consts = ClassifierTensors(lowered, self.device, compute_dtype)

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = _squeeze_channel(x).contiguous()
        if x.is_cuda:
            return cnn_classifier_cuda(x, self.consts)
        _check_features(x, self.consts.device, self.consts.input_shape)
        return cnn_classifier_plain(self.consts, x)


def make_fused_conv_block1(variables: dict, n_features: int, feature_size: int,
                           separable: bool = False,
                           compute_dtype=torch.float32, device=DEFAULT_DEVICE):
    """Build (B, H, W[, 1]) features -> (B, H//2, W//2, 16) NHWC float32
    block-1 activations from a JAX-layout variables tree, with the constants
    on `device` (the card unless the caller passes "cpu"; RuntimeError for
    CUDA without CUDA).  CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    stage = StageTensors(lower_block1(variables, separable, n_features,
                                      feature_size), resolve_device(device),
                         compute_dtype)

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        x = _squeeze_channel(x).contiguous()
        if x.is_cuda:
            return cnn_block1_cuda(x, stage)
        _check_features(x, stage.device, (n_features, feature_size))
        return cnn_block1_plain(stage, x)

    return forward


def make_fused_cnn_forward(model: SimpleCNN, compute_dtype=torch.float32):
    """Inference forward of a SimpleCNN / SimpleCNNLite with block 1 fused:
    the block-1 kernel (or its plain version), then the model's own
    `forward(..., skip_block1=True)` for the rest."""
    if not isinstance(model, SimpleCNN):
        raise TypeError(f"need a SimpleCNN, got {type(model).__name__}")
    block1 = make_fused_conv_block1(
        model.variables(), model.n_features, model.feature_size,
        model.separable, compute_dtype, _model_device(model))

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return model(block1(x), skip_block1=True)

    return forward
