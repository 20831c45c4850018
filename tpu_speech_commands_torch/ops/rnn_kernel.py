"""The GRU and LSTM classifier kernels: wrappers, launch counts and plain
versions.

`csrc/gru_classifier.cu` and `csrc/lstm_classifier.cu` replace the TPU
kernel `tpu_speech_commands/ops/pallas_rnn.py::make_fused_rnn_classifier`
for `cell_type='gru'` and `'lstm'`: a Keras GRU layer (reset_after, linear
candidate) or LSTM layer (gates [i, f, c, o], one bias) over the whole
sequence, with the dense head fused into the last layer's launch.  A
stacked model runs one launch per layer.

Each runs, by `gru_plan.gru_kernel_for` / `lstm_plan.lstm_kernel_for` of
the layer's widths:
- "tile": a tile kernel (`tsc_gru_layer`, `tsc_lstm_layer`: one warp for
  16 windows, bf16 `mma.sync` or f32 register tiles in its layout, the
  shared pieces in `csrc/rnn_tile.cuh`; plan, weight pack and CPU
  emulation in `ops/gru_plan.py` and `ops/lstm_plan.py`), inputs and units
  padded to 64 or fewer;
- "proj": inputs wider than that, two launches: the input projection
  (`csrc/rnn_projection_wgmma.cu`, `ops/rnn_projection.py`: XW = x @ W +
  b on the tensor cores, into a workspace allocated here; its first
  design `csrc/rnn_projection.cu` where `rnn_projection.projection_design`
  names it) and the tile
  kernel in projected mode (`tsc_gru_layer_proj`, `tsc_lstm_layer_proj`:
  only h @ U a step), the TPU kernel's hoisted projection;
- "simt": units padded past 64 (no shipped config), and every layer with
  `_simt=True` (the A/B baseline): the first, SIMT kernel
  (`tsc_gru_layer_simt`, `tsc_lstm_layer_simt`), whose block stages W and
  the window's features and is refused past 232,448 bytes.
No kernel stands in for another on an error.

`GRUClassifier` and `LSTMClassifier` dispatch on the tensor they are given:
a CPU tensor goes through the plain module loop (`models/rnn.py::SimpleGRU`,
`SimpleLSTM`), a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..models.rnn import SimpleGRU, SimpleLSTM
from . import _build, gru_plan, rnn_projection
from .launch_count import LaunchCount
from .gru_plan import TilePack, gru_kernel_for, pack_gru_weights
from .lstm_plan import lstm_kernel_for, pack_lstm_weights
from .rnn_projection import (ProjectedPack, pack_gru_projected,
                             pack_lstm_projected)

SOURCE = "tpu_speech_commands_torch/csrc/gru_classifier.cu"
REPLACES = "tpu_speech_commands/ops/pallas_rnn.py:223"
LSTM_SOURCE = "tpu_speech_commands_torch/csrc/lstm_classifier.cu"
LSTM_REPLACES = REPLACES

# tsc_gru_layer(x, x_bf16, batch, T, D, U, wpack, bias, head_w, head_b, C,
#   seq_out, logits, bf16_math, rows, warps, stream)
_N_ARGS = 17
_INT_ARGS = (1, 2, 3, 4, 5, 10, 13, 14, 15)
# tsc_gru_layer_simt(x, x_bf16, batch, T, D, U, w, u, b_in, b_rec, head_w,
#   head_b, C, seq_out, logits, bf16_math, stream)
_SIMT_N_ARGS = 17
_SIMT_INT_ARGS = (1, 2, 3, 4, 5, 12, 15)
# tsc_lstm_layer(x, x_bf16, batch, T, D, U, wpack, bias, head_w, head_b, C,
#   seq_out, logits, bf16_math, stream)
_LSTM_N_ARGS = 15
_LSTM_INT_ARGS = (1, 2, 3, 4, 5, 10, 13)
# tsc_lstm_layer_simt(x, x_bf16, batch, T, D, U, w, u, bias, head_w, head_b,
#   C, seq_out, logits, bf16_math, stream)
_LSTM_SIMT_N_ARGS = 16
_LSTM_SIMT_INT_ARGS = (1, 2, 3, 4, 5, 11, 14)
# tsc_gru_layer_proj / tsc_lstm_layer_proj(xw, batch, T, U, wpack, bias,
#   head_w, head_b, C, seq_out, logits, bf16_math, stream)
_PROJ_N_ARGS = 13
_PROJ_INT_ARGS = (1, 2, 3, 8, 11)
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_weight(name, t, shape, device):
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{name}: need a contiguous float32 {tuple(shape)} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _check_input(x, compute_dtype, units, what):
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
    if units > 1024:
        raise ValueError(f"the {what} kernel takes at most 1024 units, got "
                         f"{units}")


def _outputs(x, units, head_kernel, head_bias, batch=None):
    """The layer's output tensor and the (head_w, head_b, C, seq_out,
    logits) launch arguments: logits (B, C) with a head, else the h
    sequence (B, T, U).  B is x's first dimension unless given."""
    batch = x.shape[0] if batch is None else batch
    steps = x.shape[1]
    if head_kernel is not None:
        n_classes = head_kernel.shape[-1]
        _check_weight("head kernel", head_kernel, (units, n_classes), x.device)
        _check_weight("head bias", head_bias, (n_classes,), x.device)
        out = torch.empty((batch, n_classes), dtype=torch.float32,
                          device=x.device)
        return out, (head_kernel.data_ptr(), head_bias.data_ptr(), n_classes,
                     None, out.data_ptr())
    out = torch.empty((batch, steps, units), dtype=torch.float32,
                      device=x.device)
    return out, (None, None, 0, out.data_ptr(), None)


def _launch(name, n_args, int_args, x, weights, units, head_args,
            compute_dtype, split=()):
    batch, steps, d_in = x.shape
    fn = _build.bind(name, n_args, int_args)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), batch, steps, d_in,
            units, *(t.data_ptr() for t in weights), *head_args,
            int(compute_dtype == torch.bfloat16), *split, stream,
        )
    _build.check(rc, name)


def _check_pack(pack: TilePack, d_in, units, compute_dtype, device):
    if not isinstance(pack, TilePack):
        raise ValueError(f"a ({d_in}, {units}) layer takes the tile kernel: "
                         f"need a TilePack, got {type(pack).__name__}")
    if (pack.d_in, pack.units, pack.compute_dtype) != (d_in, units,
                                                       compute_dtype):
        raise ValueError(
            f"pack of a ({pack.d_in}, {pack.units}) layer for "
            f"{pack.compute_dtype}, launch of a ({d_in}, {units}) layer for "
            f"{compute_dtype}")
    for name, t in (("weights", pack.weights), ("bias", pack.bias)):
        # the kernel stages them with 16-byte loads
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"pack {name}: need a contiguous, 16-byte aligned "
                             f"tensor on {device}, got one on {t.device}")


def _check_projected(pack, d_in, units, compute_dtype, device):
    if not isinstance(pack, ProjectedPack):
        raise ValueError(f"a {d_in}-feature layer takes the projected route: "
                         f"need a ProjectedPack, got {type(pack).__name__}")
    _check_pack(pack.recurrence, 0, units, compute_dtype, device)
    if (pack.d_in, pack.compute_dtype) != (d_in, compute_dtype):
        raise ValueError(
            f"projected pack of a {pack.d_in}-feature layer for "
            f"{pack.compute_dtype}, launch of a {d_in}-feature layer for "
            f"{compute_dtype}")


def projected_recurrence_cuda(xw: torch.Tensor, batch: int,
                              pack: ProjectedPack, head_kernel=None,
                              head_bias=None) -> torch.Tensor:
    """The projected route's second launch alone: the GRU's or the LSTM's
    tile kernel in projected mode (by the pack's gates) over XW, the
    projection's output for `batch` windows (`rnn_projection_cuda`).
    Returns what the layer returns; adds one to `gru_layer_cuda.launches`
    or `lstm_layer_cuda.launches`."""
    units, cd = pack.units, pack.compute_dtype
    if xw.dtype != torch.float32 or not xw.is_cuda or not xw.is_contiguous() \
            or xw.shape[0] != -(-batch // gru_plan.TILE) \
            or xw.shape[2:] != (pack.projection.n_cols // 8, 32, 4):
        raise ValueError(f"XW of {batch} windows for this pack: need a "
                         f"contiguous float32 CUDA tensor ({-(-batch // 16)}, "
                         f"T, {pack.projection.n_cols // 8}, 32, 4), got "
                         f"{xw.dtype} {tuple(xw.shape)} on {xw.device}")
    _check_projected(pack, pack.d_in, units, cd, xw.device)
    out, head_args = _outputs(xw, units, head_kernel, head_bias, batch)
    gru = pack.projection.gates == 3
    name = "tsc_gru_layer_proj" if gru else "tsc_lstm_layer_proj"
    fn = _build.bind(name, _PROJ_N_ARGS, _PROJ_INT_ARGS)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = fn(xw.data_ptr(), batch, xw.shape[1], units,
                pack.recurrence.weights.data_ptr(),
                pack.recurrence.bias.data_ptr(), *head_args,
                int(cd == torch.bfloat16), stream)
    _build.check(rc, name)
    if gru:
        gru_layer_cuda.launches += 1
    else:
        lstm_layer_cuda.launches += 1
    return out


def _projected(x, pack: ProjectedPack, units, head_kernel, head_bias,
               compute_dtype, _mma_sync: bool | None = None
               ) -> torch.Tensor:
    """The projected route's two launches: the projection into a workspace
    (the design `rnn_projection.projection_design` names), then the tile
    kernel in projected mode over it."""
    _check_projected(pack, x.shape[2], units, compute_dtype, x.device)
    xw = rnn_projection.rnn_projection_cuda(x, pack.projection,
                                            _mma_sync=_mma_sync)
    return projected_recurrence_cuda(xw, x.shape[0], pack, head_kernel,
                                     head_bias)


def gru_layer_cuda(x: torch.Tensor, kernel: torch.Tensor,
                   recurrent_kernel: torch.Tensor, bias_input: torch.Tensor,
                   bias_recurrent: torch.Tensor, head_kernel=None,
                   head_bias=None, compute_dtype=torch.float32,
                   pack: TilePack | ProjectedPack | None = None,
                   _simt: bool = False,
                   _split: tuple[int, int] | None = None,
                   _mma_sync: bool | None = None) -> torch.Tensor:
    """Launch a GRU kernel for one layer.  x (B, T, D) float32 or bfloat16
    on a CUDA device, weights in the Keras layout (float32).  With a head:
    returns logits (B, C) float32; without: the layer's h sequence (B, T, U)
    float32.

    By `gru_plan.gru_kernel_for(D, U)`: "tile", the tile kernel on `pack`
    (`pack_gru_weights` of these weights for compute_dtype; packed here
    when None), adding one to `.launches`; `_split` (windows a warp, warps
    a block; `gru_plan.SWEEP`) overrides its work split.  "proj", the
    projection (`rnn_projection.rnn_projection_cuda`: the design
    `projection_design(pack, _mma_sync)` names, one to its count) and the
    tile kernel in projected mode (one to `.launches`) on `pack`
    (`rnn_projection.pack_gru_projected`; packed here when None).  "simt",
    or `_simt=True` (the A/B): the SIMT kernel, one to
    `GRU_SIMT.launches`."""
    units = recurrent_kernel.shape[0]
    _check_input(x, compute_dtype, units, "GRU")
    d_in = x.shape[2]
    _check_weight("kernel", kernel, (d_in, 3 * units), x.device)
    _check_weight("recurrent_kernel", recurrent_kernel, (units, 3 * units),
                  x.device)
    _check_weight("bias_input", bias_input, (3 * units,), x.device)
    _check_weight("bias_recurrent", bias_recurrent, (3 * units,), x.device)
    out, head_args = _outputs(x, units, head_kernel, head_bias)
    if x.shape[0] == 0:
        return out
    route = "simt" if _simt else gru_kernel_for(d_in, units)
    if route == "simt":
        _launch("tsc_gru_layer_simt", _SIMT_N_ARGS, _SIMT_INT_ARGS, x,
                (kernel, recurrent_kernel, bias_input, bias_recurrent), units,
                head_args, compute_dtype)
        GRU_SIMT.launches += 1
        return out
    if route == "proj":
        if pack is None:
            pack = pack_gru_projected(kernel, recurrent_kernel, bias_input,
                                      bias_recurrent, compute_dtype)
        return _projected(x, pack, units, head_kernel, head_bias,
                          compute_dtype, _mma_sync)
    if pack is None:
        pack = pack_gru_weights(kernel, recurrent_kernel, bias_input,
                                bias_recurrent, compute_dtype)
    _check_pack(pack, d_in, units, compute_dtype, x.device)
    split = _split or (gru_plan.ROWS, gru_plan.WARPS)
    _launch("tsc_gru_layer", _N_ARGS, _INT_ARGS, x, (pack.weights, pack.bias),
            units, head_args, compute_dtype, split)
    gru_layer_cuda.launches += 1
    return out


gru_layer_cuda.launches = 0
GRU_SIMT = LaunchCount()  # launches of the SIMT GRU kernel


def gru_rcp_mismatches(device) -> int:
    """How many floats d of [1, inf] the tile kernel's sigmoid reciprocal
    rounds otherwise than the true divide 1.0f / d: the claim is 0."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    fn = _build.bind("tsc_gru_rcp_check", 4, (0, 1))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # bit patterns [1.0f, +inf]
        rc = fn(0x3F800000, 0x7F800001, bad.data_ptr(), stream)
    _build.check(rc, "tsc_gru_rcp_check")
    return int(bad.item())


def lstm_layer_cuda(x: torch.Tensor, kernel: torch.Tensor,
                    recurrent_kernel: torch.Tensor, bias: torch.Tensor,
                    head_kernel=None, head_bias=None,
                    compute_dtype=torch.float32,
                    pack: TilePack | ProjectedPack | None = None,
                    _simt: bool = False,
                    _mma_sync: bool | None = None) -> torch.Tensor:
    """Launch an LSTM kernel for one layer.  x (B, T, D) float32 or
    bfloat16 on a CUDA device, weights in the Keras layout (float32, gates
    [i, f, c, o]).  With a head: returns logits (B, C) float32; without: the
    layer's h sequence (B, T, U) float32.

    By `lstm_plan.lstm_kernel_for(D, U)`: "tile", the tile kernel on `pack`
    (`pack_lstm_weights` of these weights for compute_dtype; packed here
    when None), adding one to `.launches`.  "proj", the projection (the
    design `rnn_projection.projection_design(pack, _mma_sync)` names, one
    to its count) and the tile kernel in projected mode (one to
    `.launches`) on `pack`
    (`rnn_projection.pack_lstm_projected`; packed here when None).
    "simt", or `_simt=True` (the A/B): the SIMT kernel, one to
    `LSTM_SIMT.launches`."""
    units = recurrent_kernel.shape[0]
    _check_input(x, compute_dtype, units, "LSTM")
    d_in = x.shape[2]
    _check_weight("kernel", kernel, (d_in, 4 * units), x.device)
    _check_weight("recurrent_kernel", recurrent_kernel, (units, 4 * units),
                  x.device)
    _check_weight("bias", bias, (4 * units,), x.device)
    out, head_args = _outputs(x, units, head_kernel, head_bias)
    if x.shape[0] == 0:
        return out
    route = "simt" if _simt else lstm_kernel_for(d_in, units)
    if route == "simt":
        _launch("tsc_lstm_layer_simt", _LSTM_SIMT_N_ARGS, _LSTM_SIMT_INT_ARGS,
                x, (kernel, recurrent_kernel, bias), units, head_args,
                compute_dtype)
        LSTM_SIMT.launches += 1
        return out
    if route == "proj":
        if pack is None:
            pack = pack_lstm_projected(kernel, recurrent_kernel, bias,
                                       compute_dtype)
        return _projected(x, pack, units, head_kernel, head_bias,
                          compute_dtype, _mma_sync)
    if pack is None:
        pack = pack_lstm_weights(kernel, recurrent_kernel, bias, compute_dtype)
    _check_pack(pack, d_in, units, compute_dtype, x.device)
    _launch("tsc_lstm_layer", _LSTM_N_ARGS, _LSTM_INT_ARGS, x,
            (pack.weights, pack.bias), units, head_args, compute_dtype)
    lstm_layer_cuda.launches += 1
    return out


lstm_layer_cuda.launches = 0
LSTM_SIMT = LaunchCount()  # launches of the SIMT LSTM kernel


class _RNNClassifier:
    """(B, T, D) features -> (B, C) float32 logits.  CPU tensors run the
    module's own loop; CUDA tensors launch the kernel once per layer, the
    last launch with the head.  For a model on the card, each layer the
    tile kernel takes, directly or projected, has its weights packed once,
    here: a later change to the model's weights needs a new classifier.
    `_simt` runs every layer on the SIMT kernel instead, for the A/B;
    `_mma_sync` True or False runs the projected route's projection on its
    first design or on the kernel, in place of `projection_design`'s rule.
    Subclasses name the model class, the route, the packs and the
    per-layer launch."""

    def __init__(self, model, compute_dtype=torch.float32, _simt=False,
                 _mma_sync=None):
        if not isinstance(model, self.model_cls):
            raise TypeError(f"need a {self.model_cls.__name__}, got "
                            f"{type(model).__name__}")
        if compute_dtype not in _COMPUTE_DTYPES:
            raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                            f"{compute_dtype}")
        self.model = model
        self.compute_dtype = compute_dtype
        self.simt = _simt
        self.mma_sync = _mma_sync
        self.device = next(model.parameters()).device
        on_card = self.device.type == "cuda"
        routes = {cell: self._kernel_for(cell.kernel.shape[0], cell.units)
                  for cell in model.backbone.cells()}
        self.packs = {
            cell: (self._pack if route == "tile" else self._pack_projected)(
                cell, compute_dtype)
            for cell, route in routes.items()
            if on_card and not _simt and route in ("tile", "proj")}
        if _mma_sync:  # the first design's pack, before the first call
            for pack in self.packs.values():
                if isinstance(pack, ProjectedPack):
                    pack.projection.weights

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
            seq = self._layer(seq, cell, head.kernel if last else None,
                              head.bias if last else None)
        return seq


class GRUClassifier(_RNNClassifier):
    """A SimpleGRU through the GRU kernels (`csrc/gru_classifier.cu`)."""

    model_cls = SimpleGRU
    _kernel_for = staticmethod(gru_kernel_for)

    @staticmethod
    def _pack(cell, compute_dtype):
        return pack_gru_weights(cell.kernel, cell.recurrent_kernel,
                                cell.bias_input, cell.bias_recurrent,
                                compute_dtype)

    @staticmethod
    def _pack_projected(cell, compute_dtype):
        return pack_gru_projected(cell.kernel, cell.recurrent_kernel,
                                  cell.bias_input, cell.bias_recurrent,
                                  compute_dtype)

    def _layer(self, seq, cell, head_kernel, head_bias):
        return gru_layer_cuda(seq, cell.kernel, cell.recurrent_kernel,
                              cell.bias_input, cell.bias_recurrent,
                              head_kernel, head_bias, self.compute_dtype,
                              self.packs.get(cell), _simt=self.simt,
                              _mma_sync=self.mma_sync)


class LSTMClassifier(_RNNClassifier):
    """A SimpleLSTM through the LSTM kernels (`csrc/lstm_classifier.cu`)."""

    model_cls = SimpleLSTM
    _kernel_for = staticmethod(lstm_kernel_for)

    @staticmethod
    def _pack(cell, compute_dtype):
        return pack_lstm_weights(cell.kernel, cell.recurrent_kernel,
                                 cell.bias, compute_dtype)

    @staticmethod
    def _pack_projected(cell, compute_dtype):
        return pack_lstm_projected(cell.kernel, cell.recurrent_kernel,
                                   cell.bias, compute_dtype)

    def _layer(self, seq, cell, head_kernel, head_bias):
        return lstm_layer_cuda(seq, cell.kernel, cell.recurrent_kernel,
                               cell.bias, head_kernel, head_bias,
                               self.compute_dtype, self.packs.get(cell),
                               _simt=self.simt, _mma_sync=self.mma_sync)
