"""The cepstrum kernel's plan (`csrc/cepstrum.cu`): its tile, its table, a
numpy emulation of its maps, and its plain version.

The FFT body's log-mel mode (csrc/register_fft.cuh) writes each kept
frame's n_filt log-mel values and its log energy, f32, to a (B, T, n_filt +
1) buffer; the cepstrum kernel finishes the contract of K1
(`tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend`: the DCT
product at :711, the energy column at :713, `_kernel_deltas` at :716):

    c[t, 0] = logmel[t, n_filt]                                (log energy)
    c[t, i] = sum_m logmel[t, m] dct_t[m, i],   0 < i < n_mfcc
    [c, c[t] - c[t-1] (0 at t = 0)] if deltas, batch- or time-major, f32 or bf16

as one f32 GEMM of the rows against `extended_table` (the DCT's columns 1
.. n_mfcc - 1 and a 1 that carries the energy into column 0, zero-padded to
(k_pad, n_pad)).  A block computes a BM x BN tile of whole windows,
`windows_per_block` of them, so that a delta's frame before lies in the
tile; a window longer than BM frames runs in chunks of BM rows, the last
row of each carried to the next.  K runs in slices of BK.  `emulate`
follows those maps in numpy; tests/test_torch_cepstrum.py holds it to
`cepstrum_plain` and the constants below to the source's `#define`s.

`logmel_plain` is the plain version of the body's log-mel mode, and
`DctTables` holds the DCT in the forms the frontend kernels read (the whole
table, the fused epilogue's trimmed columns, the cepstrum kernel's
extended table), and `register_layout` the register or wide block a launch
of either mode runs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend.dsp import add_deltas, decode_audio, frame_signal, safe_log
from ..frontend.filterbanks import dct_t_matrix, filterbank_matrix
from ..params import ListenerParams
from ._checks import check_row_major, row_major
from .fft_plan import SMEM_OPTIN, fft_layout

# csrc/cepstrum.cu's TSC_CEP_* tile: rows (frames) and output columns a
# tile, the K slice a stage, the threads a block (16 x 16, 8 x 8 results
# each), the pad of a k-row of the rows' stage (floats)
BM, BN, BK, THREADS, A_PAD = 128, 128, 8, 256, 4


def windows_per_block(n_features: int) -> int:
    """The whole windows a block's tile holds: max(1, BM // n_features)."""
    return max(1, BM // n_features)


def padded_shape(n_filt: int, n_mfcc: int) -> tuple[int, int]:
    """(k_pad, n_pad): n_filt + 1 rows up to a multiple of BK, n_mfcc
    columns up to a multiple of BN."""
    return -(-(n_filt + 1) // BK) * BK, -(-n_mfcc // BN) * BN


def extended_table(dct_t: np.ndarray, n_mfcc: int) -> np.ndarray:
    """(k_pad, n_pad) float32: ext[m, i] = dct_t[m, i] for 0 < i < n_mfcc,
    ext[n_filt, 0] = 1, zero elsewhere.  Row n_filt meets the log energy,
    so column 0 of the product is the energy (every other term is 0 times
    a finite log) and columns 1 .. n_mfcc - 1 the coefficients (no more
    than n_filt of them: a config with more is refused at launch)."""
    n_filt = dct_t.shape[0]
    ext = np.zeros(padded_shape(n_filt, n_mfcc), np.float32)
    ext[:n_filt, 1:n_mfcc] = dct_t[:, 1:n_mfcc]
    ext[n_filt, 0] = 1.0
    return ext


def smem_bytes() -> int:
    """The kernel's dynamic shared memory (kCepSmemBytes): the ring of two
    stages (rows k-major at a pitch of BM + A_PAD, the table's slice), or
    after the K loop the staged tile (BN + 1 floats a row) over it, then one
    carried row."""
    ring = 2 * BK * (BM + A_PAD) + 2 * BK * BN
    return 4 * (max(ring, BM * (BN + 1)) + BN)


def cepstrum_plain(logmel: torch.Tensor, dct_t: torch.Tensor, n_mfcc: int,
                   emit_deltas: bool = False, time_major: bool = False,
                   out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: (B, T, n_filt + 1) log-mel rows and the (n_filt,
    n_filt) transposed DCT -> (B, T, F), or (T, B, F) when time_major, in
    out_dtype (computed in float32)."""
    n_filt = logmel.shape[-1] - 1
    coeffs = torch.matmul(logmel[..., :n_filt], dct_t[:, 1:n_mfcc])
    out = torch.cat([logmel[..., n_filt:], coeffs], -1)
    if emit_deltas:
        out = add_deltas(out)
    if time_major:
        out = out.transpose(0, 1).contiguous()
    return out.to(out_dtype)


def logmel_plain(frontend, audio: torch.Tensor, gain=None) -> torch.Tensor:
    """The plain version of the FFT body's log-mel mode, on the plain chain
    `frontend` (`frontend/dsp.py::Frontend`): (B, S) audio -> (B,
    n_features, n_filt + 1) f32, each kept frame's log-mel values, then its
    log energy."""
    p = frontend.params
    frames = frame_signal(decode_audio(audio, gain), p.window_samples,
                          p.hop_samples)[..., -p.n_features:, :]
    powers = frontend.power_from_frames(frames)
    filt = torch.tensor(filterbank_matrix(p, frontend.feature_type),
                        device=powers.device)
    return torch.cat([safe_log(torch.matmul(powers, filt)),
                      safe_log(powers.sum(-1, keepdim=True))], -1)


def emulate(logmel: np.ndarray, table: np.ndarray, n_mfcc: int,
            emit_deltas: bool = False, time_major: bool = False) -> np.ndarray:
    """The kernel's maps in numpy (float32 products, each slice of BK summed
    in order into its tile): the blocks in launch order (the N tiles of an M
    tile consecutive), each block's whole windows, its chunks of BM rows
    with the carried row, the K slices (rows and k past the end zero), the
    store of each tile row to (b, t) or (t, b) with its delta.  Rows,
    columns and deltas a kernel bug would leave unwritten stay NaN."""
    batch, n_feat, k_rows = logmel.shape
    n_filt = k_rows - 1
    k_pad, n_pad = table.shape
    wpb = windows_per_block(n_feat)
    n_out = 2 * n_mfcc if emit_deltas else n_mfcc
    out = np.full((n_feat, batch, n_out) if time_major else
                  (batch, n_feat, n_out), np.nan, np.float32)
    rows_all = logmel.reshape(-1, k_rows).astype(np.float32)
    n_tiles = n_pad // BN
    for block in range(-(-batch // wpb) * n_tiles):
        n0, w0 = (block % n_tiles) * BN, (block // n_tiles) * wpb
        rows = min(wpb, batch - w0) * n_feat
        n_cols = min(BN, n_mfcc - n0)
        carry = np.full(BN, np.nan, np.float32)
        for c0 in range(0, rows, BM):
            acc = np.zeros((BM, BN), np.float32)
            for k0 in range(0, k_pad, BK):
                a = np.zeros((BM, BK), np.float32)
                m_hi = min(BM, rows - c0)
                k_hi = min(BK, max(0, k_rows - k0))
                g0 = w0 * n_feat + c0
                a[:m_hi, :k_hi] = rows_all[g0:g0 + m_hi, k0:k0 + k_hi]
                for k in range(BK):
                    acc += np.outer(a[:, k], table[k0 + k, n0:n0 + BN])
            for r in range(min(BM, rows - c0)):
                g = c0 + r
                b, t = w0 + g // n_feat, g % n_feat
                v = acc[r, :n_cols]
                dst = out[t, b] if time_major else out[b, t]
                dst[n0:n0 + n_cols] = v
                if emit_deltas:
                    prev = acc[r - 1, :n_cols] if r else carry[:n_cols]
                    dst[n_mfcc + n0:n_mfcc + n0 + n_cols] = \
                        v - prev if t else 0.0
            carry = acc[BM - 1].copy()
    return out


class DctTables:
    """The DCT in the forms the frontend kernels read, on a device: `dct_t`,
    the whole transposed (n_filt, n_filt) DCT (the radix-2 body, the CT
    split, the `_full_dct` A/B); `dct_trim`, its columns 1 .. n_mfcc - 1
    (n_filt, n_mfcc - 1), all the fused register and wide epilogue keeps;
    `cep_table`, `extended_table`, the cepstrum kernel's.  A config with
    more coefficients than filters, which every launch refuses, gets the
    tables of n_filt coefficients."""

    def __init__(self, p: ListenerParams, device):
        dct = dct_t_matrix(p.n_filt)
        n_mfcc = min(p.n_mfcc, p.n_filt)
        self.dct_t = row_major(dct, device)
        self.dct_trim = row_major(dct[:, 1:n_mfcc], device)
        self.cep_table = row_major(extended_table(dct, n_mfcc), device)
        check_row_major(
            (self.dct_t, self.dct_trim, self.cep_table),
            ((p.n_filt, p.n_filt), (p.n_filt, n_mfcc - 1),
             padded_shape(p.n_filt, n_mfcc)))

    def layout_for(self, p: ListenerParams, full_dct: bool = False,
                   cepstrum: bool = False):
        """The register or wide block of `self.plan` at config p: fused
        (the trimmed DCT, or with full_dct the whole one) or in log-mel
        mode (`fft_plan.fft_layout`)."""
        return fft_layout(self.plan, self.fb, p.n_filt, p.n_mfcc,
                          p.n_features, full_dct=full_dct, cepstrum=cepstrum)

    def dct_args(self, p: ListenerParams, full_dct: bool) -> tuple:
        """(pointer, dct_cols) of the fused epilogue's DCT table."""
        if full_dct:
            return self.dct_t.data_ptr(), p.n_filt
        return self.dct_trim.data_ptr(), p.n_mfcc - 1


def register_layout(consts, p: ListenerParams, full_dct: bool,
                    cepstrum: bool):
    """The register or wide block a launch runs (`DctTables.layout_for`),
    or ValueError where that mode's block fits no shared memory (the
    `_full_dct` A/B at a config whose whole DCT leaves no room)."""
    lay = consts.layout_for(p, full_dct and not cepstrum, cepstrum)
    if lay.smem_bytes > SMEM_OPTIN:
        raise ValueError(
            f"the {'whole' if full_dct else 'trimmed'} DCT of {p.n_filt} "
            f"filters leaves no block of the register FFT at n_fft "
            f"{p.n_fft} room: {lay.smem_bytes} bytes of shared memory, more "
            f"than {SMEM_OPTIN}")
    return lay


def logmel_buffer(audio: torch.Tensor, p: ListenerParams) -> torch.Tensor:
    """The (B, n_features, n_filt + 1) f32 rows the FFT body writes in
    log-mel mode: each kept frame's log-mel values, then its log energy."""
    return torch.empty((audio.shape[0], p.n_features, p.n_filt + 1),
                       dtype=torch.float32, device=audio.device)
