"""The input projection of the GRU and LSTM classifiers' projected route:
its two kernels' plans, weight packs, output layout, plain version, CPU
emulations and wrapper.

A layer whose inputs are wider than the tile kernels take (D_p >
`gru_plan.CAP_D`) runs in two launches, as the TPU kernel runs every layer
(`tpu_speech_commands/ops/pallas_rnn.py:158-166`: the input projection
hoisted out of the recurrence, one matmul a gate over all T frames, then
only h @ U in the step loop):

1. the projection: XW = X (B T x D) @ W (D x G U_p) + b, float32, W's
   columns in the tile kernels' padded gate order (gate g's unit u in
   column g U_p + u; zero where padded), b the GRU's b_in of all three
   gates or the LSTM's single bias;
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

The kernel (`csrc/rnn_projection_wgmma.cu`, `tsc_rnn_projection_wgmma`,
`PROJECTION`): `wgmma` in both modes, a persistent block of two consumer
warpgroups and a producer warpgroup walking tiles of `tile_rows` rows
(256 up to N = WIDE_N, else 128), K in slices of 128 bytes through a ring
(`wgmma_plan`): W's slices by TMA from its K-major tables (`pack_wgmma`;
shared by the two blocks of a cluster by multicast, or in bf16 mode
loaded once and kept where it fits), the rows by 16-byte `cp.async` of
each row's window.
- bf16 mode: m64nNk16 bf16, f32 accumulation.
- f32 mode: 3xTF32 on m64nNk8 tf32: x split in registers into hi =
  tf32(x) and lo = tf32(x - hi), W's hi and lo split on the host,
  hi.hi + hi.lo + lo.hi into f32 accumulators a k8 step (about 2^-22 of
  each product lost, as the cepstrum kernel's 3xTF32 loses).
x comes in the mode's type (the wrapper converts it: f32 features in bf16
mode rounded to bf16, as the first design rounds them where it stages
them), at any element boundary (each row read at its address's shift).
`emulate_wgmma` follows its arithmetic from its pack.

Which of the two runs is `projection_design`'s rule on the mode: the
kernel in f32 mode, the first design in bf16 mode, where the first design
is ahead at 300 and 600 features (PERF.md §6, K3); `_mma_sync` True or
False forces one for the A/B.

The first design (`csrc/rnn_projection.cu`, `tsc_rnn_projection`,
`PROJECTION_MMA_SYNC`): `mma.sync` in both modes.  A
block of 8 warps owns 8 of those m-tiles (128 rows, `TILES_M`) and all N
columns: warp w takes m-tiles 2 (w % 4) and 2 (w % 4) + 1 and half the
n-tiles (`n_tiles_a_warp`), so X is read from memory once.  K runs in
stages of BK columns.  Where x is in the mode's type with its rows on
4-byte boundaries, the rows come by `cp.async` of the widest of 16, 8 and
4 bytes their alignment allows through a ring of ASYNC_STAGES_F32 or
ASYNC_STAGES_BF16 stages (f32 mode up to TWO_BLOCK_NTW n-tiles a warp: two
blocks an SM, a ring of TWO_BLOCK_STAGES_F32); otherwise each thread loads
its share of the next stage into registers, converting and storing it
after this stage's products (a ring of STAGES).  The stage's B fragments,
packed on the host in fragment order (`ProjectionPack.weights`, built at
its first use), come by 16-byte `cp.async`: `mma.m16n8k16` bf16, or
3xTF32 on `mma.m16n8k8`; `emulate` follows it.

Bound at B 8192, T 23, D 300, a 48-unit GRU (operations, f32 mode): 2 x
188,416 x 300 x 144 = 16.28 GFLOP at 165 TFLOP/s (3xTF32), 0.0987 ms;
the features alone are 226.1 MB (0.0675 ms at 3.35 TB/s) and XW 108.5 MB
each way.  bf16 mode: bytes, 113.0 MB of bf16 features and XW written.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _build, gru_plan
from .gru_plan import (C_COL, C_ROW, TILE, TilePack, check_compute_dtype,
                       pack_matrix, padded)
from .launch_count import LaunchCount

SOURCE = "tpu_speech_commands_torch/csrc/rnn_projection_wgmma.cu"
MMA_SYNC_SOURCE = "tpu_speech_commands_torch/csrc/rnn_projection.cu"
REPLACES = "tpu_speech_commands/ops/pallas_rnn.py:158-166"

# the kernel's plan (csrc/rnn_projection_wgmma.cu's TSC_PJW_*;
# tests/test_torch_projection_wgmma.py holds the two together): threads a
# block (two consumer warpgroups and a producer one), bytes a staged row
# (its window of 9 16-byte chunks), the ring's most stages, the widest N
# with two m64 tiles a consumer warpgroup (tiles of 256 rows; 128 above
# it), the stages of rows bf16 mode keeps beside a resident W, the blocks
# of a cluster that share a streamed W slice
WG_THREADS, A_PITCH, WG_MAX_STAGES = 384, 144, 6
WIDE_N, RESIDENT_STAGES, CLUSTER = 144, 3, 2
# the widths it is instantiated for: N = G U_p, the GRU's 48 .. 192 and the
# LSTM's 64 .. 256
WG_WIDTHS = (48, 64, 96, 128, 144, 192, 256)
SMS = 132  # an H100's SMs: the persistent blocks of a launch, at most
# the modes whose projection is the kernel by default (`projection_design`)
WGMMA_MODES = (torch.float32,)

# the first design's constants (csrc/rnn_projection.cu;
# tests/test_torch_rnn_wide.py holds the two together)
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

PROJECTION = LaunchCount()  # launches of tsc_rnn_projection_wgmma
PROJECTION_MMA_SYNC = LaunchCount()  # of tsc_rnn_projection (the first design)


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


def k_slice(bf16: bool) -> int:
    """The kernel's K slice a stage: 128 bytes of W's type."""
    return 64 if bf16 else 32


def wgmma_k_pad(d_in: int, bf16: bool) -> int:
    """The rows of the kernel's tables: D up to a whole K slice."""
    return -(-d_in // k_slice(bf16)) * k_slice(bf16)


def m64_tiles(n_cols: int) -> int:
    """The m64 tiles a consumer warpgroup of the kernel takes: two up to
    WIDE_N columns, else one (its accumulators, n_cols / 2 floats a thread
    a tile, leave room for no more)."""
    return 2 if n_cols <= WIDE_N else 1


def tile_rows(n_cols: int) -> int:
    """The rows of the kernel's tile: two consumer warpgroups' m64 tiles."""
    return 128 * m64_tiles(n_cols)


def _w_stage_bytes(bf16: bool, resident: bool, n_cols: int) -> int:
    return 0 if resident else (1 if bf16 else 2) * 128 * n_cols


def _stage_bytes(bf16: bool, resident: bool, n_cols: int) -> int:
    """A stage of the ring: W's K slice (hi and lo in f32 mode; none when W
    is resident) and the tile's rows, A_PITCH bytes each."""
    return _w_stage_bytes(bf16, resident, n_cols) + tile_rows(n_cols) * A_PITCH


def _fixed_bytes(n_cols: int, stages: int) -> int:
    """1024 bytes of alignment slack, the bias, the producer's row table,
    the barriers (a full and an empty one a stage, and resident W's)."""
    return 1024 + 4 * n_cols + 4 * tile_rows(n_cols) + 16 * stages + 8


def _wgmma_smem(bf16: bool, resident: bool, k_pad: int, n_cols: int,
                stages: int) -> int:
    w = k_pad // k_slice(bf16) * 128 * n_cols if resident else 0
    return (w + stages * _stage_bytes(bf16, resident, n_cols)
            + _fixed_bytes(n_cols, stages))


def _ring_stages(bf16: bool, resident: bool, k_pad: int, n_cols: int) -> int:
    stages = WG_MAX_STAGES
    while stages and _wgmma_smem(bf16, resident, k_pad, n_cols,
                                 stages) > gru_plan.SMEM_OPTIN:
        stages -= 1
    return stages


class WgmmaPlan(NamedTuple):
    """The kernel's launch at (N, D, mode): W resident (bf16 only, where it
    and RESIDENT_STAGES stages of rows fit) or streamed; the ring's stages;
    the tile's rows; the tables' K rows; the block's shared memory; the
    blocks that share a streamed W slice."""
    resident: bool
    stages: int
    tile_rows: int
    k_pad: int
    smem_bytes: int
    cluster: int


def wgmma_plan(n_cols: int, d_in: int, bf16: bool) -> WgmmaPlan:
    """`tsc_rnn_projection_wgmma`'s plan, as its entry computes it."""
    k_pad = wgmma_k_pad(d_in, bf16)
    resident = bf16 and _ring_stages(True, True, k_pad,
                                     n_cols) >= RESIDENT_STAGES
    stages = _ring_stages(bf16, resident, k_pad, n_cols)
    return WgmmaPlan(resident, stages, tile_rows(n_cols), k_pad,
                     _wgmma_smem(bf16, resident, k_pad, n_cols, stages),
                     1 if resident else CLUSTER)


def w_l2_bytes(batch: int, steps: int, d_in: int, n_cols: int,
               bf16: bool) -> int:
    """The bytes of W the kernel reads from L2 in a launch: streamed, each
    cluster's tile pair one K slice a stage (both tables in f32 mode);
    resident, each persistent block (at most SMS) its whole table once."""
    plan = wgmma_plan(n_cols, d_in, bf16)
    tiles = -(-(-(-batch // TILE) * steps) // (plan.tile_rows // TILE))
    k_steps = plan.k_pad // k_slice(bf16)
    if plan.resident:
        return min(tiles, SMS) * k_steps * 128 * n_cols
    return (-(-tiles // plan.cluster) * k_steps
            * _w_stage_bytes(bf16, False, n_cols))


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32 to nearest, ties away from zero, as
    `cvt.rna.tf32.f32` does (`cepstrum_plan.tf32_rna` in torch)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@dataclass(frozen=True)
class ProjectionPack:
    """One layer's input projection.  `tables`, the kernel's
    (`pack_wgmma`): W transposed, (G U_p, `wgmma_k_pad`), K-major as
    `wgmma` reads B; bf16 mode (W,) bfloat16, f32 mode its TF32 (hi, lo)
    float32.  `bias` (G U_p,) float32."""

    bias: torch.Tensor
    d_in: int
    units: int
    gates: int
    compute_dtype: torch.dtype
    tables: tuple[torch.Tensor, ...]

    @property
    def n_cols(self) -> int:
        return self.gates * padded(self.units)

    @functools.cached_property
    def weights(self) -> torch.Tensor:
        """The first design's pack, from the tables at its first use: bf16
        mode, the B fragments of m16n8k16, (K / 16, NT, 32, 4) bfloat16
        (k-block, n-tile, lane, element: `gru_plan.pack_matrix`'s layout);
        f32 mode, the B fragments of m16n8k8 split into TF32 hi and lo,
        (K / 8, NT, 32, 4) float32 [hi(b0), hi(b1), lo(b0), lo(b1)].  K =
        `k_rows(d_in)`, NT = G U_p / 8."""
        with torch.no_grad():
            k = k_rows(self.d_in)
            w = [t.new_zeros((k, self.n_cols), dtype=torch.float32)
                 for t in self.tables]
            for m, t in zip(w, self.tables):
                m[:t.shape[1]] = t.t()
            if self.compute_dtype == torch.bfloat16:
                return pack_matrix(w[0], self.compute_dtype)
            rows, cols = _tf32_fragment_index(k // 8, self.n_cols // 8,
                                              w[0].device)
            return torch.cat([w[0][rows, cols], w[1][rows, cols]],
                             -1).contiguous()


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


def pack_wgmma(w: torch.Tensor, bf16: bool) -> tuple[torch.Tensor, ...]:
    """The kernel's tables of W (k_pad, N) float32 (rows past D zero): W
    transposed, (N, k_pad), K-major; (W,) bfloat16 in bf16 mode, (hi, lo)
    = (tf32_rna(W), tf32_rna(W - hi)) float32 in f32 mode.  TMA lays each
    K slice into shared memory in the 128-byte swizzle (`stage_image`)."""
    wt = w.t().contiguous()
    if bf16:
        return (wt.to(torch.bfloat16),)
    hi = tf32_rna(wt)
    return hi, tf32_rna(wt - hi)


def stage_image(table: torch.Tensor, kt: int) -> torch.Tensor:
    """K slice kt of a table (N, k_pad) as TMA writes it into a stage in
    the 128-byte swizzle: (N, 128 bytes) in its own dtype, row n's 16-byte
    chunk c at chunk c ^ (n % 8) (rows 128 bytes apart, the pattern
    repeating every 8 rows, 1024 bytes)."""
    per = 128 // table.element_size()
    rows = table[:, kt * per:(kt + 1) * per].reshape(table.shape[0], 8, -1)
    phys = torch.arange(8)[None, :] ^ (torch.arange(table.shape[0]) % 8
                                       )[:, None]
    out = torch.empty_like(rows)
    out[torch.arange(table.shape[0])[:, None], phys] = rows
    return out.reshape(table.shape[0], per)


def unpack_wgmma(pack: ProjectionPack) -> tuple[torch.Tensor, ...]:
    """W back from the kernel's tables as its `wgmma` descriptors read
    them: each K slice's stage image (`stage_image`), row n's logical
    chunk c from chunk c ^ (n % 8); (W,) in bf16 mode (bf16 values), (hi,
    lo) in f32 mode, each (k_pad, G U_p) float32."""
    out = []
    for table in pack.tables:
        n, k_pad = table.shape
        per = 128 // table.element_size()
        phys = torch.arange(8)[None, :] ^ (torch.arange(n) % 8)[:, None]
        slices = []
        for kt in range(k_pad // per):
            image = stage_image(table, kt).reshape(n, 8, -1)
            slices.append(image[torch.arange(n)[:, None], phys].reshape(n, per))
        out.append(torch.cat(slices, 1).t().float().contiguous())
    return tuple(out)


def pack_projection(kernel: torch.Tensor, bias: torch.Tensor, units: int,
                    compute_dtype=torch.float32) -> ProjectionPack:
    """Pack a Keras input kernel (D, G U) and the bias XW takes (G U,) on
    the weights' device: the kernel's tables, and the first design's pack
    (`ProjectionPack.weights`) where the mode runs it by default, else at
    its first use."""
    check_compute_dtype(compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    with torch.no_grad():
        d_in, gates = kernel.shape[0], kernel.shape[1] // units
        tables = pack_wgmma(
            input_matrix(kernel, units, wgmma_k_pad(d_in, bf16)), bf16)
        pack = ProjectionPack(padded_bias(bias, units), d_in, units, gates,
                              compute_dtype, tables)
        if projection_design(pack) == "mma_sync":
            pack.weights
        return pack


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


def emulate_wgmma(x: torch.Tensor, pack: ProjectionPack) -> torch.Tensor:
    """The kernel's arithmetic on the CPU from its pack: W back through its
    tables' stage images (`unpack_wgmma`), x in the mode's type, the
    accumulators started from the bias; for each k step in order (k8 in
    f32 mode, k16 in bf16), its products summed in float64 and added into
    the float32 accumulators: hi.hi, hi.lo, lo.hi in f32 mode (x split as
    the kernel splits it in registers), x.W in bf16 mode; k past D zero;
    the tile layout."""
    bf16 = pack.compute_dtype == torch.bfloat16
    w = unpack_wgmma(pack)
    k_pad = w[0].shape[0]
    xs = _rounded(x.float(), pack.compute_dtype)
    a = xs.new_zeros((*xs.shape[:2], k_pad))
    a[..., :pack.d_in] = xs
    if bf16:
        terms = ((a.double(), w[0].double()),)
        step = 16
    else:
        a_hi = tf32_rna(a)
        a_lo = tf32_rna(a - a_hi)
        hi, lo = (m.double() for m in w)
        terms = ((a_hi.double(), hi), (a_hi.double(), lo), (a_lo.double(), hi))
        step = 8
    acc = pack.bias.expand(*xs.shape[:2], -1).clone()
    for k0 in range(0, k_pad, step):
        for left, right in terms:
            acc = (acc.double() + left[..., k0:k0 + step]
                   @ right[k0:k0 + step]).float()
    return to_tiles(acc, pack.bias)


def projection_design(pack: ProjectionPack,
                      _mma_sync: bool | None = None) -> str:
    """Which design `rnn_projection_cuda` launches: "wgmma" (the kernel) or
    "mma_sync" (the first design).  `_mma_sync` True or False forces one
    (the A/B); None, the rule: the kernel in WGMMA_MODES (f32, where it is
    ahead of the first design from 150 features), the first design in bf16
    mode (ahead at 300 and 600 features)."""
    if _mma_sync is None:
        return "wgmma" if pack.compute_dtype in WGMMA_MODES else "mma_sync"
    return "mma_sync" if _mma_sync else "wgmma"


def _check_pack(x: torch.Tensor, pack: ProjectionPack, wgmma: bool) -> None:
    tensors = (pack.bias, *pack.tables) if wgmma else (pack.bias,
                                                       pack.weights)
    if (any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
            for t in tensors)):
        raise ValueError(f"projection pack: need contiguous, 16-byte aligned "
                         f"tensors on {x.device}, got them on "
                         f"{pack.bias.device}")
    if x.shape[2] != pack.d_in:
        raise ValueError(f"x has {x.shape[2]} features, the pack {pack.d_in}")
    if not takes(pack.n_cols):
        raise ValueError(f"the projection kernel takes N = G U_p of 48 .. "
                         f"256, got {pack.n_cols}")


def rnn_projection_cuda(x: torch.Tensor, pack: ProjectionPack,
                        _mma_sync: bool | None = None) -> torch.Tensor:
    """Launch the projection: x (B, T, D) float32 or bfloat16, a contiguous
    CUDA tensor -> XW (ceil(B / 16), T, G U_p / 8, 32, 4) float32 in the
    recurrence's layout (`to_tiles`), computed in the pack's compute dtype.
    By `projection_design(pack, _mma_sync)`: the kernel
    (`tsc_rnn_projection_wgmma`) on x in the pack's compute dtype, one to
    `PROJECTION.launches`, or the first design (`tsc_rnn_projection`) on x
    as it is, one to `PROJECTION_MMA_SYNC.launches`.  A CPU tensor
    raises."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, T, D) tensor, got "
                         f"{tuple(x.shape)}")
    wgmma = projection_design(pack, _mma_sync) == "wgmma"
    _check_pack(x, pack, wgmma)
    batch, steps, d_in = x.shape
    n_cols = pack.n_cols
    xw = torch.empty((-(-batch // TILE), steps, n_cols // 8, 32, 4),
                     dtype=torch.float32, device=x.device)
    if xw.numel() == 0:
        return xw
    bf16 = int(pack.compute_dtype == torch.bfloat16)
    if wgmma:
        x = x.to(pack.compute_dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wgmma:
            name = "tsc_rnn_projection_wgmma"
            hi, lo = pack.tables[0], pack.tables[-1]  # bf16: one table
            rc = _build.bind(name, 13, (1, 2, 3, 4, 5, 8, 11))(
                x.data_ptr(), int(x.dtype == torch.bfloat16), batch, steps,
                d_in, n_cols, hi.data_ptr(), lo.data_ptr(), hi.shape[1],
                pack.bias.data_ptr(), xw.data_ptr(), bf16, stream)
        else:
            name = "tsc_rnn_projection"
            rc = _build.bind(name, 11, (1, 2, 3, 4, 5, 9))(
                x.data_ptr(), int(x.dtype == torch.bfloat16), batch, steps,
                d_in, n_cols, pack.weights.data_ptr(), pack.bias.data_ptr(),
                xw.data_ptr(), bf16, stream)
    _build.check(rc, name)
    if wgmma:
        PROJECTION.launches += 1
    else:
        PROJECTION_MMA_SYNC.launches += 1
    return xw
