"""The GRU classifier kernel: wrapper, launch count and plain version.

`csrc/gru_classifier.cu` replaces the TPU kernel
`tpu_speech_commands/ops/pallas_rnn.py::make_fused_rnn_classifier` for
`cell_type='gru'`: a Keras GRU layer (reset_after, linear candidate) over
the whole sequence, with the dense head fused into the last layer's launch.
A stacked model runs one launch per layer.

`GRUClassifier` dispatches on the tensor it is given: a CPU tensor goes
through the plain module loop (`models/rnn.py::SimpleGRU`), a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..models.rnn import SimpleGRU
from . import _build

SOURCE = "tpu_speech_commands_torch/csrc/gru_classifier.cu"
REPLACES = "tpu_speech_commands/ops/pallas_rnn.py:223"

# tsc_gru_layer(x, x_bf16, batch, T, D, U, w, u, b_in, b_rec, head_w,
#   head_b, C, seq_out, logits, bf16_math, stream)
_N_ARGS = 17
_INT_ARGS = (1, 2, 3, 4, 5, 12, 15)
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_weight(name, t, shape, device):
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name}: need a contiguous float32 {tuple(shape)} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def gru_layer_cuda(x: torch.Tensor, kernel: torch.Tensor,
                   recurrent_kernel: torch.Tensor, bias_input: torch.Tensor,
                   bias_recurrent: torch.Tensor, head_kernel=None,
                   head_bias=None, compute_dtype=torch.float32) -> torch.Tensor:
    """Launch the GRU kernel for one layer.  x (B, T, D) float32 or bfloat16
    on a CUDA device, weights in the Keras layout (float32).  With a head:
    returns logits (B, C) float32; without: the layer's h sequence (B, T, U)
    float32.  Every launch adds one to `.launches`."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, T, D) tensor, got "
                         f"{tuple(x.shape)}")
    batch, steps, d_in = x.shape
    units = recurrent_kernel.shape[0]
    if units > 1024:
        raise ValueError(f"the GRU kernel takes at most 1024 units, got {units}")
    _check_weight("kernel", kernel, (d_in, 3 * units), x.device)
    _check_weight("recurrent_kernel", recurrent_kernel, (units, 3 * units),
                  x.device)
    _check_weight("bias_input", bias_input, (3 * units,), x.device)
    _check_weight("bias_recurrent", bias_recurrent, (3 * units,), x.device)
    if head_kernel is not None:
        n_classes = head_kernel.shape[-1]
        _check_weight("head kernel", head_kernel, (units, n_classes), x.device)
        _check_weight("head bias", head_bias, (n_classes,), x.device)
        out = torch.empty((batch, n_classes), dtype=torch.float32,
                          device=x.device)
        seq_ptr, logits_ptr = None, out.data_ptr()
        head_ptrs = (head_kernel.data_ptr(), head_bias.data_ptr())
    else:
        n_classes = 0
        out = torch.empty((batch, steps, units), dtype=torch.float32,
                          device=x.device)
        seq_ptr, logits_ptr = out.data_ptr(), None
        head_ptrs = (None, None)
    if batch == 0:
        return out
    fn = _build.bind("tsc_gru_layer", _N_ARGS, _INT_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), batch, steps, d_in,
            units, kernel.data_ptr(), recurrent_kernel.data_ptr(),
            bias_input.data_ptr(), bias_recurrent.data_ptr(), *head_ptrs,
            n_classes, seq_ptr, logits_ptr,
            int(compute_dtype == torch.bfloat16), stream,
        )
    _build.check(rc, "tsc_gru_layer")
    gru_layer_cuda.launches += 1
    return out


gru_layer_cuda.launches = 0


class GRUClassifier:
    """(B, T, D) features -> (B, C) float32 logits of a SimpleGRU.  CPU
    tensors run the module's own loop; CUDA tensors launch the kernel once
    per layer, the last launch with the head."""

    def __init__(self, model: SimpleGRU, compute_dtype=torch.float32):
        if not isinstance(model, SimpleGRU):
            raise TypeError(f"need a SimpleGRU, got {type(model).__name__}")
        if compute_dtype not in _COMPUTE_DTYPES:
            raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                            f"{compute_dtype}")
        self.model = model
        self.compute_dtype = compute_dtype

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4 and x.shape[-1] == 1:
            x = x[..., 0]
        if x.device.type == "cpu":
            return self.model(x, self.compute_dtype)
        cells = self.model.backbone.cells()
        head = self.model.score_predict
        seq = x.contiguous()
        for i, cell in enumerate(cells):
            last = i == len(cells) - 1
            seq = gru_layer_cuda(
                seq, cell.kernel, cell.recurrent_kernel, cell.bias_input,
                cell.bias_recurrent,
                head.kernel if last else None, head.bias if last else None,
                self.compute_dtype,
            )
        return seq
