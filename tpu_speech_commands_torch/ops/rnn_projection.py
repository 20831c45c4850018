"""The input projection of the GRU and LSTM classifiers' projected route
(`csrc/rnn_projection.cu`, `tsc_rnn_projection`): its plan, weight pack,
output layout, plain version, CPU emulation and wrapper.

A layer whose inputs are wider than the tile kernels take (D_p >
`gru_plan.CAP_D`) runs in two launches, as the TPU kernel runs every layer
(`tpu_speech_commands/ops/pallas_rnn.py:158-166`: the input projection
hoisted out of the recurrence, one matmul a gate over all T frames, then
only h @ U in the step loop):

1. this kernel: XW = X (B T x D) @ W (D x G U_p) + b, float32, W's columns
   in the tile kernels' padded gate order (gate g's unit u in column
   g U_p + u; zero where padded), b the GRU's b_in of all three gates or
   the LSTM's single bias;
2. the tile kernel in projected mode (`gru_tile_kernel` /
   `lstm_tile_kernel` with D_p = 0; `tsc_gru_layer_proj`,
   `tsc_lstm_layer_proj`): its accumulators start from XW_t and only
   h @ U runs a step.

XW is written in the order the recurrence reads it (`to_tiles`): tiles of
16 windows, [B / 16][T][n-tile][lane] x 4 floats, a lane's four C elements
of an `mma` n-tile (rows g and g + 8, columns 2t and 2t + 1) in one 16-byte
word.  A recurrence warp copies its step's words by 16-byte `cp.async`, 512
contiguous bytes a warp an n-tile, and the projection's warps store their
accumulators in the same words.

Design of the kernel (`mma.sync` on the tensor cores in both modes).  A
block of 8 warps owns 8 of those m-tiles (128 rows, `TILES_M`) and all N
columns: warp w takes m-tiles 2 (w % 4) and 2 (w % 4) + 1 and half the
n-tiles (`n_tiles_a_warp`), so X is read from memory once.  K runs in
stages of BK columns.  Where x is in the mode's type with its rows on
4-byte boundaries (f32 features in f32 mode, bf16 ones of even D in bf16
mode), the rows come by `cp.async` of the widest of 16, 8 and 4 bytes
their alignment allows through a ring of
ASYNC_STAGES_F32 or ASYNC_STAGES_BF16 stages (f32 mode up to
TWO_BLOCK_NTW n-tiles a warp: two blocks an SM, a ring of
TWO_BLOCK_STAGES_F32); otherwise each thread loads
its share of the next stage into registers, converting and storing it
after this stage's products (a ring of STAGES).  The stage's B fragments,
packed once on the host in fragment order (`pack_projection`), come by
16-byte `cp.async`.
- bf16 mode: `mma.m16n8k16` bf16, f32 accumulation; x rounded to bf16
  where it is staged (the plain module's `_rounded`).
- f32 mode: 3xTF32, `mma.m16n8k8` tf32: x split in registers into hi =
  tf32(x) and lo = tf32(x - hi), W split on the host, and a_lo b_hi +
  a_hi b_lo + a_hi b_hi accumulated in f32 (about 2^-22 of each product
  lost, as the cepstrum kernel's 3xTF32 loses).  Chosen over FFMA: the
  product is 16.3 GFLOP at 300 features (B 8192, T 23, 48-unit GRU),
  0.33 ms at the f32 FFMA peak against 0.10 ms at 3xTF32's rate.

Bound at that shape (operations, f32 mode): 2 x 188,416 x 300 x 144 =
16.28 GFLOP at 165 TFLOP/s (3xTF32), 0.0987 ms; the features alone are
226.1 MB (0.0675 ms at 3.35 TB/s) and XW 108.5 MB each way.  bf16 mode:
bytes, 113.0 MB of bf16 features and XW written.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build, gru_plan
from .gru_plan import (C_COL, C_ROW, TILE, TilePack, check_compute_dtype,
                       pack_matrix, padded)
from .launch_count import LaunchCount

SOURCE = "tpu_speech_commands_torch/csrc/rnn_projection.cu"
REPLACES = "tpu_speech_commands/ops/pallas_rnn.py:158-166"

# the kernel's constants (csrc/rnn_projection.cu; tests/test_torch_rnn_wide.py
# holds the two together)
WARPS = 8          # warps a block: 4 m-tile pairs x 2 column halves
TILES_M = 8        # m-tiles (16 rows each) a block
K_PAD = 64         # the pack's k rows are padded to a multiple of this
BK_F32 = 16        # k a stage: two m16n8k8 steps
BK_BF16 = 64       # four m16n8k16 steps
PITCH_F32 = 20     # floats a staged row (16 + 4: conflict-free fragments)
PITCH_BF16 = 72    # bf16 a staged row (64 + 8)
STAGES = 2         # the ring of rows staged through registers
ASYNC_STAGES_F32 = 4   # the cp.async ring, f32 mode
ASYNC_STAGES_BF16 = 3  # bf16 mode
# f32 mode's cp.async ring up to TWO_BLOCK_NTW n-tiles a warp: two blocks an
# SM on a ring of TWO_BLOCK_STAGES_F32
TWO_BLOCK_NTW = 12
TWO_BLOCK_STAGES_F32 = 2
# the n-tiles a warp takes (half the N / 8 of an instantiation): N = G U_p
# for the GRU (48 .. 192) and the LSTM (64 .. 256)
N_TILES_A_WARP = (3, 4, 6, 8, 9, 12, 16)

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
# m16n8k8 tf32 B ("col"): b0 = (k t, n g), b1 = (k t + 4, n g)
B_ROW_TF32 = _T[:, None] + 4 * np.arange(2)[None, :]
B_COL_TF32 = np.repeat(_G[:, None], 2, axis=1)

PROJECTION = LaunchCount()  # launches of tsc_rnn_projection


def n_tiles_a_warp(n_cols: int) -> int:
    """The n-tiles a warp of the kernel takes for N = n_cols columns."""
    return n_cols // 16


def takes(n_cols: int) -> bool:
    """Whether the kernel has an instantiation for N = n_cols columns."""
    return n_cols % 16 == 0 and n_tiles_a_warp(n_cols) in N_TILES_A_WARP


def smem_bytes(n_cols: int, bf16: bool, async_rows: bool = True) -> int:
    """A block's shared memory, `proj_smem` of the source: the ring's stages
    (the cp.async ring's, or with `async_rows` False the register-staged
    one's) of the 128 staged rows and the stage's B fragments."""
    n_t = n_cols // 8
    a_stage = 16 * TILES_M * (2 * PITCH_BF16 if bf16 else 4 * PITCH_F32)
    b_stage = (BK_BF16 // 16 * 8 if bf16 else BK_F32 // 8 * 16) * n_t * 32
    if not bf16 and async_rows and n_tiles_a_warp(n_cols) <= TWO_BLOCK_NTW:
        stages = TWO_BLOCK_STAGES_F32
    else:
        stages = ((ASYNC_STAGES_BF16 if bf16 else ASYNC_STAGES_F32)
                  if async_rows else STAGES)
    return stages * (a_stage + b_stage)


def k_rows(d_in: int) -> int:
    return -(-d_in // K_PAD) * K_PAD


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32 to nearest, ties away from zero, as
    `cvt.rna.tf32.f32` does (`cepstrum_plan.tf32_rna` in torch)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@dataclass(frozen=True)
class ProjectionPack:
    """One layer's input projection for the kernel.  `weights`: bf16 mode,
    the B fragments of m16n8k16, (K / 16, NT, 32, 4) bfloat16 (k-block,
    n-tile, lane, element: `gru_plan.pack_matrix`'s layout); f32 mode, the
    B fragments of m16n8k8 split into TF32 hi and lo, (K / 8, NT, 32, 4)
    float32 [hi(b0), hi(b1), lo(b0), lo(b1)].  K = `k_rows(d_in)`, NT = G
    U_p / 8.  `bias` (G U_p,) float32."""

    weights: torch.Tensor
    bias: torch.Tensor
    d_in: int
    units: int
    gates: int
    compute_dtype: torch.dtype

    @property
    def n_cols(self) -> int:
        return self.gates * padded(self.units)


@dataclass(frozen=True)
class ProjectedPack:
    """A layer of the projected route: the projection's pack and the tile
    kernel's recurrence-only pack (U alone, `d_in` 0; its bias the GRU's
    [b_rec_z, b_rec_r, 0, b_rec_h] or the LSTM's zeros, the rest is in
    XW)."""

    projection: ProjectionPack
    recurrence: TilePack
    d_in: int
    units: int
    compute_dtype: torch.dtype


def input_matrix(kernel: torch.Tensor, units: int, rows: int) -> torch.Tensor:
    """W (rows, G U_p) float32 from a Keras kernel (D, G U): gate g's unit u
    in column g U_p + u; zero where padded."""
    d_in, gates = kernel.shape[0], kernel.shape[1] // units
    u_p = padded(units)
    m = kernel.new_zeros((rows, gates, u_p), dtype=torch.float32)
    m[:d_in, :, :units] = kernel.float().reshape(d_in, gates, units)
    return m.reshape(rows, gates * u_p)


def padded_bias(bias: torch.Tensor, units: int) -> torch.Tensor:
    """(G U,) -> (G U_p,) float32, zero where padded."""
    gates, u_p = bias.shape[0] // units, padded(units)
    b = bias.new_zeros((gates, u_p), dtype=torch.float32)
    b[:, :units] = bias.float().reshape(gates, units)
    return b.reshape(-1)


def _tf32_fragment_index(kb: int, nt: int, device):
    rows = 8 * np.arange(kb)[:, None, None, None] + B_ROW_TF32[None, None]
    cols = 8 * np.arange(nt)[None, :, None, None] + B_COL_TF32[None, None]
    shape = (kb, nt, 32, 2)
    return (torch.as_tensor(np.broadcast_to(rows, shape).copy(), device=device),
            torch.as_tensor(np.broadcast_to(cols, shape).copy(), device=device))


def pack_projection(kernel: torch.Tensor, bias: torch.Tensor, units: int,
                    compute_dtype=torch.float32) -> ProjectionPack:
    """Pack a Keras input kernel (D, G U) and the bias XW takes (G U,) for
    the kernel, on the weights' device."""
    check_compute_dtype(compute_dtype)
    with torch.no_grad():
        d_in, gates = kernel.shape[0], kernel.shape[1] // units
        w = input_matrix(kernel, units, k_rows(d_in))
        if compute_dtype == torch.bfloat16:
            weights = pack_matrix(w, compute_dtype)
        else:
            hi = tf32_rna(w)
            lo = tf32_rna(w - hi)
            rows, cols = _tf32_fragment_index(w.shape[0] // 8, w.shape[1] // 8,
                                              w.device)
            weights = torch.cat([hi[rows, cols], lo[rows, cols]], -1)
        return ProjectionPack(weights.contiguous(), padded_bias(bias, units),
                              d_in, units, gates, compute_dtype)


def unpack_projection(pack: ProjectionPack) -> tuple[torch.Tensor, ...]:
    """The padded W back from the pack through the fragment maps: (W,) in
    bf16 mode (bf16 values), (hi, lo) in f32 mode, each (K, G U_p)
    float32."""
    kb, nt = pack.weights.shape[:2]
    if pack.compute_dtype == torch.bfloat16:
        return (gru_plan.unpack_matrix(TilePack(
            pack.weights, pack.bias, pack.d_in, pack.units,
            pack.compute_dtype)),)
    rows, cols = _tf32_fragment_index(kb, nt, pack.weights.device)
    out = []
    for half in (slice(0, 2), slice(2, 4)):
        m = pack.weights.new_zeros((8 * kb, 8 * nt))
        m[rows, cols] = pack.weights[..., half]
        out.append(m)
    return tuple(out)


def pack_gru_projected(kernel, recurrent_kernel, bias_input, bias_recurrent,
                       compute_dtype=torch.float32) -> ProjectedPack:
    """A Keras GRU layer for the projected route: XW takes b_in of all three
    gates, the recurrence b_rec of z and r and b_rec_h apart."""
    with torch.no_grad():
        units = recurrent_kernel.shape[0]
        u_p = padded(units)
        br = bias_recurrent.float().reshape(3, units)
        bias = recurrent_kernel.new_zeros((4, u_p), dtype=torch.float32)
        bias[0, :units] = br[0]
        bias[1, :units] = br[1]
        bias[3, :units] = br[2]
        u_only = gru_plan.padded_matrix(kernel[:0], recurrent_kernel)
        rec = TilePack(pack_matrix(u_only, compute_dtype), bias, 0, units,
                       compute_dtype)
        return ProjectedPack(
            pack_projection(kernel, bias_input, units, compute_dtype), rec,
            kernel.shape[0], units, compute_dtype)


def pack_lstm_projected(kernel, recurrent_kernel, bias,
                        compute_dtype=torch.float32) -> ProjectedPack:
    """A Keras LSTM layer for the projected route: XW takes the bias, the
    recurrence a zero one."""
    with torch.no_grad():
        units = recurrent_kernel.shape[0]
        u_only = gru_plan.padded_matrix(kernel[:0], recurrent_kernel)
        rec = TilePack(pack_matrix(u_only, compute_dtype),
                       u_only.new_zeros((4, padded(units))), 0, units,
                       compute_dtype)
        return ProjectedPack(
            pack_projection(kernel, bias, units, compute_dtype), rec,
            kernel.shape[0], units, compute_dtype)


def to_tiles(rows: torch.Tensor, fill=None) -> torch.Tensor:
    """(B, T, N) float32 -> the kernel's XW layout (ceil(B / 16), T, N / 8,
    32, 4): tile w, step t, n-tile n, lane, element e holds window 16 w +
    C_ROW[lane, e], column 8 n + C_COL[lane, e]; windows past B hold `fill`
    (N,) (the kernel writes the bias there: their features are zero), or
    zeros."""
    batch, steps, n_cols = rows.shape
    warps = -(-batch // TILE)
    full = rows.new_zeros((warps * TILE, steps, n_cols))
    full[:batch] = rows
    if fill is not None:
        full[batch:] = fill
    full = full.reshape(warps, TILE, steps, n_cols).transpose(1, 2)
    r = torch.as_tensor(C_ROW, device=rows.device)
    c = (8 * torch.arange(n_cols // 8, device=rows.device)[:, None, None]
         + torch.as_tensor(C_COL, device=rows.device))          # (NT, 32, 4)
    return full[:, :, r[None].expand_as(c), c].contiguous()


def _rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if compute_dtype == torch.bfloat16 \
        else t


def rnn_projection_plain(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, units: int,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """The plain version: x (B, T, D) float32 or bfloat16, a Keras input
    kernel (D, G U) and the bias XW takes (G U,) -> XW in the kernel's
    layout (`to_tiles`, the bias for windows past B), float32; bf16 mode
    rounds x and W to bf16 (f32 accumulation), as the plain module does."""
    w = input_matrix(kernel, units, kernel.shape[0])
    b = padded_bias(bias, units)
    rows = torch.matmul(_rounded(x.float(), compute_dtype),
                        _rounded(w, compute_dtype)) + b
    return to_tiles(rows, b)


def exact_projection(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, units: int,
                     compute_dtype=torch.float32):
    """(XW, bound), both float64 in the kernel's layout: XW of the operands
    the mode multiplies (bf16 mode: x and W rounded to bf16) in float64,
    and how far an f32 result may lie from it.  A sum of D products
    accumulated in f32 in any order lies within gamma_D sum |x_k w_k| of
    the exact sum (gamma_D = D u / (1 - D u), u = 2^-24); 3xTF32 adds at
    most 2^-20 of each |x_k w_k| (the dropped lo lo product and the lo
    parts' TF32 roundings), and 1e-6 covers the bias's rounding.  The plain
    version's f32 sums and the kernel's are both held to this: at D 600 the
    f32 sums alone differ by 7e-5 where a value's terms sum to 50 in
    magnitude."""
    d_in = kernel.shape[0]
    w = input_matrix(kernel, units, d_in).double()
    xs = x.double()
    if compute_dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).double()
        xs = x.to(torch.bfloat16).double()
    b = padded_bias(bias, units).double()
    u = 2.0 ** -24
    gamma = d_in * u / (1 - d_in * u) + (
        2.0 ** -20 if compute_dtype == torch.float32 else 0.0)
    exact = to_tiles(xs @ w + b, b)
    bound = to_tiles(gamma * (xs.abs() @ w.abs()) + 1e-6,
                     torch.full_like(b, 1e-6))
    return exact, bound


def emulate(x: torch.Tensor, pack: ProjectionPack) -> torch.Tensor:
    """The kernel's arithmetic on the CPU from its pack: W back through the
    fragment maps, x rounded as the kernel stages it (bf16), or split into
    TF32 hi and lo (f32 mode: a_lo b_hi + a_hi b_lo + a_hi b_hi, in float64
    and then float32), the bias, the tile layout."""
    d_in = pack.d_in
    xs = x.float()
    if pack.compute_dtype == torch.bfloat16:
        (w,) = unpack_projection(pack)
        rows = _rounded(xs, torch.bfloat16) @ w[:d_in]
    else:
        hi, lo = (m[:d_in].double() for m in unpack_projection(pack))
        a_hi = tf32_rna(xs)
        a_lo = tf32_rna(xs - a_hi)
        a_hi, a_lo = a_hi.double(), a_lo.double()
        rows = (a_lo @ hi + a_hi @ lo + a_hi @ hi).float()
    return to_tiles(rows + pack.bias, pack.bias)


def _check_pack(x: torch.Tensor, pack: ProjectionPack) -> None:
    if (pack.weights.device != x.device or pack.bias.device != x.device
            or not pack.weights.is_contiguous()
            or pack.weights.data_ptr() % 16 or not pack.bias.is_contiguous()):
        raise ValueError(f"projection pack: need contiguous, 16-byte aligned "
                         f"tensors on {x.device}, got them on "
                         f"{pack.weights.device}")
    if x.shape[2] != pack.d_in:
        raise ValueError(f"x has {x.shape[2]} features, the pack {pack.d_in}")
    if not takes(pack.n_cols):
        raise ValueError(f"the projection kernel takes N = G U_p of 48 .. "
                         f"256, got {pack.n_cols}")


def rnn_projection_cuda(x: torch.Tensor, pack: ProjectionPack) -> torch.Tensor:
    """Launch the projection kernel: x (B, T, D) float32 or bfloat16, a
    contiguous CUDA tensor -> XW (ceil(B / 16), T, G U_p / 8, 32, 4)
    float32 in the recurrence's layout (`to_tiles`), computed in the pack's
    compute dtype.  Adds one to `PROJECTION.launches`; a CPU tensor
    raises."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, T, D) tensor, got "
                         f"{tuple(x.shape)}")
    _check_pack(x, pack)
    batch, steps, d_in = x.shape
    n_cols = pack.n_cols
    xw = torch.empty((-(-batch // TILE), steps, n_cols // 8, 32, 4),
                     dtype=torch.float32, device=x.device)
    if xw.numel() == 0:
        return xw
    fn = _build.bind("tsc_rnn_projection", 11, (1, 2, 3, 4, 5, 9))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), batch, steps,
                d_in, n_cols, pack.weights.data_ptr(), pack.bias.data_ptr(),
                xw.data_ptr(), int(pack.compute_dtype == torch.bfloat16),
                stream)
    _build.check(rc, "tsc_rnn_projection")
    PROJECTION.launches += 1
    return xw
