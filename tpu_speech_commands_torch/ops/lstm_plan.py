"""The LSTM tile kernel's plan (`csrc/lstm_classifier.cu`,
`lstm_tile_kernel`): its route, the weight pack, and a CPU emulation of its
warps, on the GRU tile kernel's fragment maps and padding
(`ops/gru_plan.py`, which this module imports and does not copy).

The kernel runs one Keras LSTM layer (gates side by side [i | f | c | o],
one bias, tanh on the candidate and on the cell) with one warp for 16
windows, the rows of an mma tile, over all T steps.  Units are padded to
U_p and inputs to D_p, both multiples of 16, with zero weights and biases:
a padded unit stays exactly 0 (i = f = o = 1/2 and tanh(0) = 0, so
c = c / 2 + 0 and h = tanh(c) / 2 from c = 0).

Every gate takes the whole [x_t | h] @ [W; U], K = D_p + U_p: one
accumulator a gate, n-tiles j, NU + j, 2 NU + j and 3 NU + j for 8-unit
group j (NU = U_p / 8).  bf16 mode, `mma.sync.m16n8k16`: h lives as the
A fragments of the next step (`gru_plan.C_TO_A`: the C elements of n-tiles
2k and 2k + 1 are k-block k), rounded to bf16; c is one f32 register a C
element.  f32 mode: the GRU's per-warp shared buffer (`gru_plan.slot`,
`X_PITCH`) and the padded [W; U] itself, row-major.
"""
from __future__ import annotations

import torch

from .gru_plan import (C_TO_A, CAP_D, CAP_U, ROWS, WARPS, X_PITCH, TilePack,
                       WarpTiles, check_compute_dtype, pack_matrix, padded,
                       padded_matrix, sigmoid, slot)

__all__ = ["CAP_D", "CAP_U", "ROWS", "WARPS", "X_PITCH", "emulate",
           "lstm_kernel_for", "pack_lstm_weights"]


def lstm_kernel_for(d_in: int, units: int) -> str:
    """"tile" where the padded widths fit the tile kernel's instantiations,
    else "simt" (`tsc_lstm_layer_simt`)."""
    return "tile" if padded(d_in) <= CAP_D and padded(units) <= CAP_U else "simt"


def pack_lstm_weights(kernel, recurrent_kernel, bias,
                      compute_dtype=torch.float32) -> TilePack:
    """Pack one Keras LSTM layer (kernel (D, 4U), recurrent_kernel (U, 4U),
    bias (4U,), float32) for the tile kernel, on the weights' device: the
    padded [W; U] (its B fragments in bf16 mode) and the bias (4, U_p)
    [b_i, b_f, b_c, b_o]."""
    check_compute_dtype(compute_dtype)
    with torch.no_grad():
        d_in, units = kernel.shape[0], recurrent_kernel.shape[0]
        m = padded_matrix(kernel, recurrent_kernel)
        b = m.new_zeros((4, padded(units)))
        b[:, :units] = bias.float().reshape(4, units)
        return TilePack(pack_matrix(m, compute_dtype), b, d_in, units,
                        compute_dtype)


def emulate(pack: TilePack, x: torch.Tensor, head_kernel=None,
            head_bias=None, c_to_a=C_TO_A, h_slot=slot,
            padded_units=False) -> torch.Tensor:
    """Run the LSTM tile kernel's warps on the CPU (`gru_plan.WarpTiles`,
    16 windows a warp).  x (B, T, D) float32 or bfloat16 -> logits (B, C)
    with a head, else the h sequence (B, T, U; U_p with `padded_units`),
    float32.  `c_to_a` and `h_slot` are the maps by which the bf16 and the
    f32 mode hand h to the next step (tests perturb them)."""
    tiles = WarpTiles(pack, x, ROWS, c_to_a, h_slot)
    nu, h = tiles.nu, tiles.zeros()
    c = tiles.zeros()
    for step in range(tiles.steps):
        products = tiles.products(step, h)
        gi, gf, gc, go = (b + products(tiles.every, q * nu)
                          for q, b in enumerate(tiles.bias))
        c = sigmoid(gf) * c + sigmoid(gi) * torch.tanh(gc)
        h = sigmoid(go) * torch.tanh(c)
        tiles.end_step(step, h)
    return tiles.output(h, head_kernel, head_bias, padded_units)
