"""The GRU tile kernel's plan (`csrc/gru_classifier.cu`, `gru_tile_kernel`):
its padding and route, the `mma.sync` fragment maps, the weight pack, and a
CPU emulation of its warps.

The kernel runs one Keras GRU layer (reset_after, linear candidate, gates
side by side [z | r | h]) with one warp for 16 windows, the rows of an mma
tile, over all T steps.
Units are padded to U_p and inputs to D_p, both multiples of 16; the
padding rows and columns of every weight and bias are zero, so a padded
unit stays exactly 0 (z = r = 1/2, cand = 0, h = h / 2).

bf16 mode, `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`.  Each step
computes [x_t | h] @ [W; U] for the z and r gates into one accumulator
each, and x_t @ W_h, h @ U_h into two more (cand = xh + r * hh): 4 U_p / 8
n-tiles of f32 accumulators.  A lane (g = lane >> 2, t = lane & 3) holds
rows g and g + 8 of each tile (`A_ROW`, `A_COL`, `C_ROW`, `C_COL`), so the
accumulators of n-tiles 2k and 2k + 1 are the A fragment of k-block k
(`C_TO_A`): the new h, rounded to bf16, is the next step's A operand in
the same registers.  The B operands are packed once, in fragment order: a
lane's four bf16 of (k-block, n-tile) are one 8-byte word at
[k][n][lane] (`pack_gru_weights`).

f32 mode runs on the CUDA cores in the same C layout: a lane owns rows g
and g + 8 and columns 2t, 2t + 1 of every n-tile.  Each step the warp
writes x_t and h into a per-warp shared buffer, k-major, rows g and g + 8
side by side (`slot`, `X_PITCH` floats a k), and reads, per k, that pair
and the float2 weights of every n-tile at [k][n][t]: the padded [W; U]
matrix itself, row-major.

Projected mode (route "proj", inputs wider than CAP_D): D_p = 0, the
pack holds U alone, and the accumulators of the gates x_t feeds start from
XW_t, the input projection's output (`ops/rnn_projection.py`,
`csrc/rnn_projection.cu`) in the C layout, which each warp copies into a
ring of two steps in shared memory a step ahead (`tile_smem_bytes`).

`emulate` runs these maps on the CPU in torch (`WarpTiles`, whatever the
gates: `ops/lstm_plan.py` runs the LSTM tile kernel's on it); tests hold it
against the plain module (`models/rnn.py`) and the JAX kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fft_plan import SMEM_OPTIN  # a block's opt-in shared memory

TILE = 16        # the rows of an mma tile
ROWS = 16        # windows a warp, a tile's rows
WARPS = 4        # warps a block (the sweep's pick): 128 blocks at B = 8192
PAD = 16         # D and U are padded to multiples of an mma k-block
CAP_D = 64       # the largest padded widths instantiated (no spills)
CAP_U = 64
X_PITCH = 20     # f32 mode: floats a k-row of the per-warp buffer
SHIPPED = (32, 48)  # (D_p, U_p) of every shipped checkpoint (D 20, U 48)
# (windows a warp, warps a block) that chip_smoke.py sweeps; 8 windows a
# warp (rows g + 8 of each tile idle) is instantiated at the shipped shape
# only
SWEEP = ((16, 2), (16, 4), (16, 8), (8, 4), (8, 8))

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
_I8, _I4 = np.arange(8), np.arange(4)
# register element i of a lane: (row, column) within the fragment's tile
A_ROW = _G[:, None] + 8 * ((_I8 >> 1) & 1)               # 16 x 16, row-major
A_COL = 2 * _T[:, None] + (_I8 & 1) + 8 * (_I8 >> 2)
B_ROW = 2 * _T[:, None] + (_I4 & 1) + 8 * (_I4 >> 1)     # 16 x 8, "col"
B_COL = np.repeat(_G[:, None], 4, axis=1)
C_ROW = _G[:, None] + 8 * (_I4 >> 1)                     # 16 x 8 f32
C_COL = 2 * _T[:, None] + (_I4 & 1)
# A element i of k-block k = C element C_TO_A[i][1] of n-tile 2k + C_TO_A[i][0]
C_TO_A = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3))


def slot(row):
    """f32 mode: where row `row` of the warp's 16 sits in a k-row of the
    per-warp buffer; rows g and g + 8 are one float2."""
    return 2 * (row % 8) + row // 8


def padded(n: int) -> int:
    return -(-n // PAD) * PAD


def kernel_for(d_in: int, units: int) -> str:
    """Either tile kernel's route for a layer of these widths: "tile" where
    both padded widths fit its instantiations; "proj" where only the units
    do (the projection kernel, then the tile kernel in projected mode: any
    D); else "simt", the first design."""
    if padded(units) > CAP_U:
        return "simt"
    return "tile" if padded(d_in) <= CAP_D else "proj"


def gru_kernel_for(d_in: int, units: int) -> str:
    """The GRU's route (`kernel_for`): "tile", "proj" or "simt"
    (`tsc_gru_layer_simt`)."""
    return kernel_for(d_in, units)


def tile_smem_bytes(d_p: int, u_p: int, bf16: bool, gates: int = 3,
                    warps: int = WARPS) -> int:
    """A tile kernel's block of shared memory (`tile_smem` of csrc/
    gru_classifier.cu, 3 gates, and csrc/lstm_classifier.cu, 4): the bias,
    the packed weights, f32 mode's warp buffers of D_p + U_p k-rows, and in
    projected mode (d_p 0) each warp's ring of two steps of XW, a 16-byte
    word a lane an n-tile."""
    n_t, k = gates * u_p // 8, d_p + u_p
    weights = (k // 16 * n_t * 256 if bf16 else
               k * gates * u_p * 4 + warps * k * X_PITCH * 4)
    ring = warps * 2 * n_t * 512 if d_p == 0 else 0
    return 16 * u_p + weights + ring


def simt_smem_bytes(steps: int, d_in: int, units: int, gates: int) -> int:
    """The SIMT kernels' block at its smallest tile, one window (`smem_floats`
    of either .cu: W, U, the biases (the GRU's two, the LSTM's one), the
    window's features and the h double buffer): their launch is refused
    past SMEM_OPTIN."""
    g = gates * units
    biases = 2 if gates == 3 else 1
    return 4 * (d_in * g + units * g + biases * g + steps * d_in + 2 * units)


@dataclass(frozen=True)
class TilePack:
    """One layer's weights for a tile kernel (the GRU's, or the LSTM's of
    `ops/lstm_plan.py`).  `weights`: bf16 mode, the B fragments (KB, NT, 32,
    4) bfloat16, k-block, n-tile, lane, element; f32 mode, the padded
    [W; U] (D_p + U_p, G U_p) float32 of G gates.  `bias` (4, U_p) float32:
    the GRU's b_in + b_rec of z, of r, then b_in and b_rec of h; the LSTM's
    b_i, b_f, b_c, b_o."""

    weights: torch.Tensor
    bias: torch.Tensor
    d_in: int
    units: int
    compute_dtype: torch.dtype

    @property
    def d_p(self) -> int:
        return padded(self.d_in)

    @property
    def u_p(self) -> int:
        return padded(self.units)


def padded_matrix(kernel, recurrent_kernel) -> torch.Tensor:
    """[W; U] (D_p + U_p, G U_p) float32 of a layer of G gates (kernel
    (D, G U), recurrent_kernel (U, G U)): gate g's unit u in column
    g U_p + u, the input rows first; zero where padded."""
    d_in, units = kernel.shape[0], recurrent_kernel.shape[0]
    gates = recurrent_kernel.shape[1] // units
    d_p, u_p = padded(d_in), padded(units)
    m = kernel.new_zeros((d_p + u_p, gates, u_p), dtype=torch.float32)
    m[:d_in, :, :units] = kernel.float().reshape(d_in, gates, units)
    m[d_p:d_p + units, :, :units] = recurrent_kernel.float().reshape(
        units, gates, units)
    return m.reshape(d_p + u_p, gates * u_p)


def _fragment_index(kb: int, nt: int, device):
    """Row and column of [W; U] for each (k-block, n-tile, lane, element)."""
    rows = 16 * np.arange(kb)[:, None, None, None] + B_ROW[None, None]
    cols = 8 * np.arange(nt)[None, :, None, None] + B_COL[None, None]
    shape = (kb, nt, 32, 4)
    return (torch.as_tensor(np.broadcast_to(rows, shape).copy(), device=device),
            torch.as_tensor(np.broadcast_to(cols, shape).copy(), device=device))


def check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")


def pack_matrix(m: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A tile kernel's weights from the padded [W; U]: its B fragments in
    bf16 mode, the matrix itself in f32 mode."""
    if compute_dtype == torch.bfloat16:
        rows, cols = _fragment_index(m.shape[0] // 16, m.shape[1] // 8,
                                     m.device)
        return m.to(torch.bfloat16)[rows, cols].contiguous()
    return m.contiguous()


def pack_gru_weights(kernel, recurrent_kernel, bias_input, bias_recurrent,
                     compute_dtype=torch.float32) -> TilePack:
    """Pack one Keras GRU layer (kernel (D, 3U), recurrent_kernel (U, 3U),
    biases (3U,), float32) for the tile kernel, on the weights' device."""
    check_compute_dtype(compute_dtype)
    with torch.no_grad():
        d_in, units = kernel.shape[0], recurrent_kernel.shape[0]
        m = padded_matrix(kernel, recurrent_kernel)
        bi = bias_input.float().reshape(3, units)
        br = bias_recurrent.float().reshape(3, units)
        bias = m.new_zeros((4, padded(units)))
        bias[0, :units] = bi[0] + br[0]
        bias[1, :units] = bi[1] + br[1]
        bias[2, :units] = bi[2]
        bias[3, :units] = br[2]
        return TilePack(pack_matrix(m, compute_dtype), bias, d_in, units,
                        compute_dtype)


def unpack_matrix(pack: TilePack) -> torch.Tensor:
    """The padded [W; U] (float32; bf16 values in bf16 mode) back from the
    pack, through the fragment maps."""
    if pack.compute_dtype == torch.float32:
        return pack.weights.clone()
    kb, nt = pack.weights.shape[:2]
    m = pack.weights.new_zeros((16 * kb, 8 * nt), dtype=torch.float32)
    rows, cols = _fragment_index(kb, nt, m.device)
    m[rows, cols] = pack.weights.float()
    return m


def _rnd(v, bf16: bool):
    return v.to(torch.bfloat16).float() if bf16 else v


def sigmoid(v):
    return 1.0 / (1.0 + torch.exp(-v))


class WarpTiles:
    """A tile kernel's warps on the CPU, whatever its gates: x (B, T, D)
    float32 or bfloat16 through the fragment maps, `rows` windows a warp
    (ROWS, or 8 as the GRU's sweep runs) in the first rows of its 16-row
    tiles; rows past them or past B load zeros and store nothing.  h is in
    the C layout, (warps, n-tile, lane, element) float32.  `c_to_a` and
    `h_slot` are the maps by which the bf16 and the f32 mode hand h to the
    next step (tests perturb them).

    Per step: `products(step, h)` gives fn(ks, n0), the step's [x_t | h]
    over rows `ks` of [W; U] (`every`, `xs` the input rows, `hs` the
    recurrent ones, in the mode's k units) into the NU n-tiles from `n0`;
    `end_step` stores the new h; `output` is the layer's result."""

    def __init__(self, pack: TilePack, x: torch.Tensor, rows=None,
                 c_to_a=C_TO_A, h_slot=slot):
        self.pack, self.h_slot = pack, h_slot
        self.bf16 = bf16 = pack.compute_dtype == torch.bfloat16
        self.rows = rows = rows or ROWS
        self.batch, self.steps, d_in = batch, steps, _ = x.shape
        d_p, u_p = pack.d_p, pack.u_p
        self.nu = nu = u_p // 8
        kbx, kbh = d_p // 16, u_p // 16
        self.warps = warps = -(-batch // rows)
        xb = x.new_zeros((warps * rows, steps, d_p), dtype=torch.float32)
        xb[:batch, :, :d_in] = x.float()
        self.xp = x.new_zeros((warps, TILE, steps, d_p), dtype=torch.float32)
        self.xp[:, :rows] = _rnd(xb, bf16).reshape(warps, rows, steps, d_p)
        self.c_row, c_col = torch.as_tensor(C_ROW), torch.as_tensor(C_COL)
        self.cols = 8 * torch.arange(nu)[:, None, None] + c_col  # (nu, 32, 4)
        # each lane's bias of each of the 4 rows and n-tile (n, lane, element)
        self.bias = pack.bias.float()[:, self.cols]
        self.seq = torch.zeros((warps, TILE, steps, u_p))
        self.every = slice(None)
        # n-tiles of [W; U], NU a gate
        nt = pack.weights.shape[1] if bf16 else pack.weights.shape[1] // 8
        if bf16:
            # the B fragments back through their maps: (KB, NT, 16, 8) tiles
            self.b_mat = unpack_matrix(pack).reshape(
                kbx + kbh, 16, nt, 8).transpose(1, 2)
            self.a_col = (16 * torch.arange(kbx)[None, :, None]
                          + torch.as_tensor(A_COL)[:, None])
            self.src = torch.as_tensor(c_to_a)
            self.kbh = kbh
            self.xs, self.hs = slice(0, kbx), slice(kbx, None)
        else:
            # [k][n][t]: the float2 of columns 2t, 2t + 1 of n-tile n
            self.w32 = pack.weights.reshape(d_p + u_p, nt, 4, 2)[:, :, _T]
            self.buf = torch.zeros((warps, d_p + u_p, X_PITCH))
            self.xs, self.hs = slice(0, d_p), slice(d_p, None)

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.warps, self.nu, 32, 4))

    def projected(self, xw: torch.Tensor, step: int, gate: int) -> torch.Tensor:
        """Projected mode: gate `gate`'s XW_t of each warp in the C layout
        (warps, NU, 32, 4), from XW in the projection's layout (B / 16, T,
        NT, 32, 4) (`rnn_projection.to_tiles`)."""
        nu = self.nu
        return xw[:self.warps, step, gate * nu:(gate + 1) * nu].float()

    def products(self, step: int, h: torch.Tensor):
        warps, nu, d_p = self.warps, self.nu, self.pack.d_p
        c_row, c_col = self.c_row, torch.as_tensor(C_COL)
        if self.bf16:
            a_row = torch.as_tensor(A_ROW)
            xa = self.xp[:, :, step][:, a_row[:, None, :], self.a_col]  # (W, 32, KBx, 8)
            hl = h.permute(0, 2, 1, 3)                           # (W, 32, nu, 4)
            src = self.src
            ha = _rnd(torch.stack([hl[:, :, 2 * k + src[:, 0], src[:, 1]]
                                   for k in range(self.kbh)], 2), True)
            a = torch.cat([xa, ha], 2)
            a_mat = a.new_zeros((warps, a.shape[2], 16, 16))
            a_mat[:, :, a_row, torch.as_tensor(A_COL)] = a.permute(0, 2, 1, 3)

            def fn(kbs, n0):
                c = torch.einsum("wkij,knjl->wnil", a_mat[:, kbs],
                                 self.b_mat[kbs, n0:n0 + nu])
                return c[:, :, c_row, c_col]                     # (W, nu, 32, 4)

            return fn
        self.buf[:, :d_p, slot(torch.arange(TILE))] = \
            self.xp[:, :, step].transpose(1, 2)
        # per k, a lane reads rows g and g + 8 and the float2 of each n-tile
        # at [k][n][t]; c0, c1 row g, c2, c3 row g + 8
        g = torch.as_tensor(_G)
        a0, a1 = self.buf[:, :, slot(g)], self.buf[:, :, slot(g + 8)]  # (W, K, 32)

        def fn(ks, n0):
            w = self.w32[ks, n0:n0 + nu]                         # (k, nu, 32, 2)
            return torch.stack([
                torch.einsum("wkl,knl->wnl", a[:, ks], w[..., j])
                for a in (a0, a1) for j in (0, 1)], -1)

        return fn

    def end_step(self, step: int, h: torch.Tensor) -> None:
        nu = self.nu
        self.seq[:, self.c_row[None].expand(nu, -1, -1), step, self.cols] = h
        if not self.bf16:
            self.buf[:, self.pack.d_p + self.cols,
                     self.h_slot(self.c_row)[None].expand(nu, -1, -1)] = h

    def output(self, h, head_kernel=None, head_bias=None,
               padded_units=False) -> torch.Tensor:
        """logits (B, C) with a head, else the h sequence (B, T, U; U_p with
        `padded_units`), float32."""
        warps, rows, batch = self.warps, self.rows, self.batch
        u_p, units = self.pack.u_p, self.pack.units
        if head_kernel is None:
            seq = self.seq[:, :rows].reshape(warps * rows, self.steps, u_p)[:batch]
            return seq if padded_units else seq[:, :, :units]
        # the head: each lane's columns, then a sum over the lanes of a row
        hw = torch.zeros((u_p, head_kernel.shape[1]))
        hw[:units] = _rnd(head_kernel.float(), self.bf16)
        part = torch.einsum("wnle,nlec->wlec", _rnd(h, self.bf16), hw[self.cols])
        part = part.reshape(warps, 8, 4, 2, 2, -1).sum((2, 4))  # (W, g, half, C)
        logits = part.transpose(1, 2).reshape(warps, TILE, -1)[:, :rows]
        return logits.reshape(warps * rows, -1)[:batch] + head_bias.float()


def emulate(pack: TilePack, x: torch.Tensor, head_kernel=None,
            head_bias=None, rows=None, c_to_a=C_TO_A, h_slot=slot,
            padded_units=False, xw=None) -> torch.Tensor:
    """Run the GRU tile kernel's warps on the CPU (`WarpTiles`).  x (B, T,
    D) float32 or bfloat16 -> logits (B, C) with a head, else the h sequence
    (B, T, U; U_p with `padded_units`), float32.  Projected mode: `pack`
    holds U alone (`rnn_projection.pack_gru_projected`), x is (B, T, 0) and
    `xw` the projection's output, which starts z, r and xh."""
    tiles = WarpTiles(pack, x, rows, c_to_a, h_slot)
    nu, h = tiles.nu, tiles.zeros()
    for step in range(tiles.steps):
        products = tiles.products(step, h)
        # [x_t | h] into z and r; x_t @ W_h and h @ U_h apart
        z, r, xh, hh = tiles.bias
        if xw is not None:
            z, r, xh = (b + tiles.projected(xw, step, q)
                        for q, b in enumerate((z, r, xh)))
        z = z + products(tiles.every, 0)
        r = r + products(tiles.every, nu)
        xh = xh + products(tiles.xs, 2 * nu)
        hh = hh + products(tiles.hs, 2 * nu)
        zz, rr = sigmoid(z), sigmoid(r)
        h = zz * h + (1.0 - zz) * (xh + rr * hh)
        tiles.end_step(step, h)
    return tiles.output(h, head_kernel, head_bias, padded_units)
