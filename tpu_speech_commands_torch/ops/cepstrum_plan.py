"""The cepstrum kernel's plan (`csrc/cepstrum_wgmma.cu`, and its first
design `csrc/cepstrum.cu`): their tiles, their tables, numpy emulations of
their maps, and their plain version.

The FFT body's log-mel mode (csrc/register_fft.cuh) writes each kept
frame's n_filt log-mel values and its log energy, f32, to a (B, T, n_filt +
1) buffer; the cepstrum kernel finishes the contract of K1
(`tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend`: the DCT
product at :711, the energy column at :713, `_kernel_deltas` at :716):

    c[t, 0] = logmel[t, n_filt]                                (log energy)
    c[t, i] = sum_m logmel[t, m] dct_t[m, i],   0 < i < n_mfcc
    [c, c[t] - c[t-1] (0 at t = 0)] if deltas, batch- or time-major, f32 or bf16

as one GEMM of the rows against the DCT's columns 1 .. n_mfcc - 1
extended by a 1 that carries the energy into column 0.  Both designs tile
it by whole windows, `windows_per_block` of them a block, so that a
delta's frame before lies in the tile; a window longer than 128 frames
runs in chunks of 128 rows, the last row of each carried to the next.

- The kernel (`cepstrum_wgmma.cu`): 3xTF32 `wgmma` products.  The table is
  the extension transposed, (n_pad, k_pad), K-major as TF32 `wgmma` takes
  it, split on the host into a TF32 high part and the TF32 rounding of the
  rest (`split_tables`); the kernel splits each row element the same way
  in registers and sums hi.hi + hi.lo + lo.hi into f32 accumulators.
  The column tile `n_tile(n_mfcc)` is a multiple of 8 sized to the
  coefficients (`TILES`, one instantiation each); K runs in slices of
  TILE_K through a ring of `ring_stages` stages.  `emulate` follows its
  maps and its split in numpy.
- The first design (`cepstrum.cu`, `_simt=True`): a register-tiled f32
  FFMA GEMM on the SIMT cores against `extended_table`, (k_pad, n_pad),
  in BM x BN tiles and K slices of BK; `emulate_simt` follows its maps.

tests/test_torch_cepstrum.py holds both emulations to `cepstrum_plain` and
the constants below to the sources' `#define`s.

`logmel_plain` is the plain version of the body's log-mel mode, and
`DctTables` holds the DCT in the forms the frontend kernels read (the whole
table, the fused epilogue's trimmed columns, the cepstrum kernels'
tables), and `register_layout` the register or wide block a launch of
either mode runs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..frontend.dsp import add_deltas, decode_audio, frame_signal, safe_log
from ..frontend.filterbanks import dct_t_matrix, filterbank_matrix
from ..params import ListenerParams
from ._checks import check_row_major, row_major
from .fft_plan import (SMEM_OPTIN, SMEM_PER_SM, SMEM_RESERVED, cepstrum_mode,
                       fft_layout, logmel_filterbank, logmel_steps)

# csrc/cepstrum_wgmma.cu's TSC_CEPW_*: rows (frames) a tile (two consumer
# warpgroups of 64), the K slice a stage (32 floats: one row of the
# 128-byte swizzle), the widest column tile, a row of the rows' stage
# (floats: the slice's window, the nine 16-byte chunks from the one at or
# below its first element), the threads a block (two consumer warpgroups
# and a producer warpgroup), the ring's most stages, the widest tile that
# runs two blocks an SM
TILE_M, TILE_K, MAX_TILE_N, A_PITCH = 128, 32, 224, 36
WG_THREADS, MAX_STAGES, TWO_BLOCK_TILE = 384, 8, 32
# the column tiles the kernel is instantiated for
TILES = tuple(range(8, MAX_TILE_N + 1, 8))

# csrc/cepstrum.cu's TSC_CEP_* tile (the first design): rows (frames) and
# output columns a tile, the K slice a stage, the threads a block (16 x 16,
# 8 x 8 results each), the pad of a k-row of the rows' stage (floats)
BM, BN, BK, THREADS, A_PAD = 128, 128, 8, 256, 4


def windows_per_block(n_features: int) -> int:
    """The whole windows a block's tile holds (both designs): max(1, BM //
    n_features)."""
    return max(1, BM // n_features)


def n_tile(n_mfcc: int) -> int:
    """The kernel's column tile for n_mfcc coefficients: the fewest tiles
    of at most MAX_TILE_N columns, each a multiple of 8 (a `wgmma` width),
    so that the tiles hold fewer than 8 columns past n_mfcc each."""
    n_tiles = -(-n_mfcc // MAX_TILE_N)
    return -(-n_mfcc // (8 * n_tiles)) * 8


def table_shape(n_filt: int, n_mfcc: int) -> tuple[int, int]:
    """(n_pad, k_pad) of the kernel's split tables: n_mfcc columns up to
    whole tiles of `n_tile`, n_filt + 1 rows up to a multiple of TILE_K."""
    tile = n_tile(n_mfcc)
    return -(-n_mfcc // tile) * tile, -(-(n_filt + 1) // TILE_K) * TILE_K


def padded_shape(n_filt: int, n_mfcc: int) -> tuple[int, int]:
    """(k_pad, n_pad) of the first design's table: n_filt + 1 rows up to a
    multiple of BK, n_mfcc columns up to a multiple of BN."""
    return -(-(n_filt + 1) // BK) * BK, -(-n_mfcc // BN) * BN


def _extension(dct_t: np.ndarray, n_mfcc: int, shape) -> np.ndarray:
    """(k, n) float32 of the given shape: ext[m, i] = dct_t[m, i] for 0 < i
    < n_mfcc, ext[n_filt, 0] = 1, zero elsewhere."""
    n_filt = dct_t.shape[0]
    ext = np.zeros(shape, np.float32)
    ext[:n_filt, 1:n_mfcc] = dct_t[:, 1:n_mfcc]
    ext[n_filt, 0] = 1.0
    return ext


def extended_table(dct_t: np.ndarray, n_mfcc: int) -> np.ndarray:
    """The first design's table, (k_pad, n_pad) float32: ext[m, i] =
    dct_t[m, i] for 0 < i < n_mfcc, ext[n_filt, 0] = 1, zero elsewhere.
    Row n_filt meets the log energy, so column 0 of the product is the
    energy (every other term is 0 times a finite log) and columns 1 ..
    n_mfcc - 1 the coefficients (no more than n_filt of them: a config
    with more is refused at launch)."""
    return _extension(dct_t, n_mfcc, padded_shape(dct_t.shape[0], n_mfcc))


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 x rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32` does: the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tables(dct_t: np.ndarray, n_mfcc: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's tables, each (n_pad, k_pad) float32 (`table_shape`):
    the extension (`extended_table`'s values) transposed, K-major as TF32
    `wgmma` reads B, split into hi = tf32_rna(ext) and lo = tf32_rna(ext -
    hi); hi + lo is ext to about 2^-22 of each value."""
    n_pad, k_pad = table_shape(dct_t.shape[0], n_mfcc)
    ext = np.ascontiguousarray(_extension(dct_t, n_mfcc, (k_pad, n_pad)).T)
    hi = tf32_rna(ext)
    return hi, tf32_rna(ext - hi)


def stage_bytes(tile: int) -> int:
    """A stage of the kernel's ring: the tables' K slices (hi, then lo,
    tile x TILE_K floats each) and the rows' (TILE_M rows at A_PITCH)."""
    return 4 * (2 * tile * TILE_K + TILE_M * A_PITCH)


def blocks_per_sm(tile: int) -> int:
    """The kernel's launch bounds: two blocks an SM up to TWO_BLOCK_TILE
    columns, else one."""
    return 2 if tile <= TWO_BLOCK_TILE else 1


def _fixed_bytes(tile: int, stages: int) -> int:
    """1024 bytes of alignment slack, the carried row and the barriers
    (a full and an empty one a stage, and the tile's)."""
    return 1024 + 4 * tile + 8 * (2 * stages + 1)


def ring_stages(tile: int) -> int:
    """The ring's depth: as many stages as the block's share of the SM's
    shared memory holds, at most MAX_STAGES (three or more at every
    tile)."""
    blocks = blocks_per_sm(tile)
    budget = min(SMEM_OPTIN, SMEM_PER_SM // blocks - SMEM_RESERVED)
    stages = MAX_STAGES
    while _fixed_bytes(tile, stages) + stages * stage_bytes(tile) > budget:
        stages -= 1
    return stages


def wgmma_smem_bytes(tile: int) -> int:
    """The kernel's dynamic shared memory at a column tile: the ring (the
    staged tile, TILE_M rows of tile + 4 floats, over it after each
    chunk's K loop) and `_fixed_bytes`."""
    stages = ring_stages(tile)
    return stages * stage_bytes(tile) + _fixed_bytes(tile, stages)


def smem_bytes() -> int:
    """The first design's dynamic shared memory (kCepSmemBytes): the ring
    of two stages (rows k-major at a pitch of BM + A_PAD, the table's
    slice), or after the K loop the staged tile (BN + 1 floats a row) over
    it, then one carried row."""
    ring = 2 * BK * (BM + A_PAD) + 2 * BK * BN
    return 4 * (max(ring, BM * (BN + 1)) + BN)


class CepTables(NamedTuple):
    """The cepstrum kernels' tables on a device: `hi` and `lo`, the
    kernel's (`split_tables`), and `ext`, the first design's
    (`extended_table`)."""
    hi: torch.Tensor
    lo: torch.Tensor
    ext: torch.Tensor


def cep_tables(dct_t: np.ndarray, n_mfcc: int, device) -> CepTables:
    """`CepTables` of the (n_filt, n_filt) transposed DCT at n_mfcc
    coefficients, row-major on `device`."""
    n_filt = dct_t.shape[0]
    tables = CepTables(*(row_major(t, device) for t in split_tables(
        dct_t, n_mfcc)), row_major(extended_table(dct_t, n_mfcc), device))
    check_row_major(tables, (table_shape(n_filt, n_mfcc),) * 2
                    + (padded_shape(n_filt, n_mfcc),))
    return tables


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


def _emulate_blocks(logmel: np.ndarray, n_mfcc: int, tile: int,
                    n_tiles: int, emit_deltas: bool, time_major: bool,
                    chunk_product) -> np.ndarray:
    """The maps both designs share: the blocks in launch order (the N tiles
    of an M tile consecutive), each block's whole windows, its chunks of
    128 rows with the carried row, the store of each tile row to (b, t) or
    (t, b) with its delta.  chunk_product(g0, m_hi, n0) gives a chunk's
    (128, tile) accumulators: block rows g0 .. g0 + m_hi - 1 (the rest zero)
    against the columns from n0.  Rows, columns and deltas a kernel bug
    would leave unwritten stay NaN."""
    batch, n_feat, _ = logmel.shape
    wpb = windows_per_block(n_feat)
    n_out = 2 * n_mfcc if emit_deltas else n_mfcc
    out = np.full((n_feat, batch, n_out) if time_major else
                  (batch, n_feat, n_out), np.nan, np.float32)
    for block in range(-(-batch // wpb) * n_tiles):
        n0, w0 = (block % n_tiles) * tile, (block // n_tiles) * wpb
        rows = min(wpb, batch - w0) * n_feat
        n_cols = min(tile, n_mfcc - n0)
        carry = np.full(tile, np.nan, np.float32)
        for c0 in range(0, rows, BM):
            m_hi = min(BM, rows - c0)
            acc = chunk_product(w0 * n_feat + c0, m_hi, n0)
            for r in range(m_hi):
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


def emulate(logmel: np.ndarray, hi: np.ndarray, lo: np.ndarray, n_mfcc: int,
            emit_deltas: bool = False, time_major: bool = False) -> np.ndarray:
    """The kernel's maps and arithmetic in numpy: its tiles of `n_tile`
    columns over the split tables hi, lo (n_pad, k_pad); each row element
    split as the kernel splits it in registers (hi = tf32_rna(x), lo =
    tf32_rna(x - hi)); for each k8 step in order, the three TF32 products
    hi.hi, hi.lo, lo.hi (float32) added into the chunk's float32
    accumulators; rows and k past the end zero."""
    k_rows = logmel.shape[2]
    n_pad, k_pad = hi.shape
    tile = n_tile(n_mfcc)
    rows_all = logmel.reshape(-1, k_rows).astype(np.float32)
    a_hi_all = tf32_rna(rows_all)
    a_lo_all = tf32_rna(rows_all - a_hi_all)

    def chunk_product(g0, m_hi, n0):
        a_hi = np.zeros((BM, k_pad), np.float32)
        a_lo = np.zeros((BM, k_pad), np.float32)
        a_hi[:m_hi, :k_rows] = a_hi_all[g0:g0 + m_hi]
        a_lo[:m_hi, :k_rows] = a_lo_all[g0:g0 + m_hi]
        b_hi, b_lo = hi[n0:n0 + tile].T, lo[n0:n0 + tile].T
        acc = np.zeros((BM, tile), np.float32)
        for k0 in range(0, k_pad, 8):
            k = slice(k0, k0 + 8)
            acc += a_hi[:, k] @ b_hi[k]
            acc += a_hi[:, k] @ b_lo[k]
            acc += a_lo[:, k] @ b_hi[k]
        return acc

    return _emulate_blocks(logmel, n_mfcc, tile, n_pad // tile, emit_deltas,
                           time_major, chunk_product)


def emulate_simt(logmel: np.ndarray, table: np.ndarray, n_mfcc: int,
                 emit_deltas: bool = False,
                 time_major: bool = False) -> np.ndarray:
    """The first design's maps in numpy (float32 products, each slice of BK
    summed in order into its tile): BM x BN tiles of `extended_table`
    (k_pad, n_pad), K slices (rows and k past the end zero)."""
    k_rows = logmel.shape[2]
    k_pad, n_pad = table.shape
    rows_all = logmel.reshape(-1, k_rows).astype(np.float32)

    def chunk_product(g0, m_hi, n0):
        acc = np.zeros((BM, BN), np.float32)
        for k0 in range(0, k_pad, BK):
            a = np.zeros((BM, BK), np.float32)
            k_hi = min(BK, max(0, k_rows - k0))
            a[:m_hi, :k_hi] = rows_all[g0:g0 + m_hi, k0:k0 + k_hi]
            for k in range(BK):
                acc += np.outer(a[:, k], table[k0 + k, n0:n0 + BN])
        return acc

    return _emulate_blocks(logmel, n_mfcc, BN, n_pad // BN, emit_deltas,
                           time_major, chunk_product)


class DctTables:
    """The DCT in the forms the frontend kernels read, on a device: `dct_t`,
    the whole transposed (n_filt, n_filt) DCT (the radix-2 body, the CT
    split, the `_full_dct` A/B); `dct_trim`, its columns 1 .. n_mfcc - 1
    (n_filt, n_mfcc - 1), all the fused register and wide epilogue keeps;
    `cep_table`, the cepstrum kernels' (`CepTables`).  A config with more
    coefficients than filters, which every launch refuses, gets the tables
    of n_filt coefficients."""

    def __init__(self, p: ListenerParams, device):
        dct = dct_t_matrix(p.n_filt)
        n_mfcc = min(p.n_mfcc, p.n_filt)
        self.dct_t = row_major(dct, device)
        self.dct_trim = row_major(dct[:, 1:n_mfcc], device)
        self.cep_table = cep_tables(dct, n_mfcc, device)
        check_row_major((self.dct_t, self.dct_trim),
                        ((p.n_filt, p.n_filt), (p.n_filt, n_mfcc - 1)))

    def stage_register(self, plan, fb, p: ListenerParams, device):
        """The register or wide body's tables on `device` (`plan`, `fb`
        their plans): `plan_twiddle`, plan.twiddle as float32 rows; the
        packed filterbank and its int32 lane / filter / segment table, of
        the fused plan `fb` (`filt_packed`, `fb_table`: the fused epilogue
        and log-mel mode's first tail read it) and of its log-mel plan
        (`fb_logmel`, `fft_plan.logmel_filterbank`; log-mel mode's tail
        reads `filt_packed_logmel`, its step tables' weights, and
        `fb_table_logmel`, the plan's table then its step descriptors,
        `fft_plan.logmel_steps`); `cepstrum`
        (`fft_plan.cepstrum_mode`: log-mel mode and the cepstrum kernel)
        and `layout`, that mode's block."""
        self.plan, self.fb = plan, fb
        self.fb_logmel = logmel_filterbank(fb, plan.lanes)
        self.cepstrum = cepstrum_mode(plan, fb, p.n_filt, p.n_mfcc,
                                      p.n_features)
        self.layout = self.layout_for(p, cepstrum=self.cepstrum)
        self.plan_twiddle = row_major(plan.twiddle, device)
        self.filt_packed = row_major(fb.packed, device)
        self.fb_table = row_major(fb.table, device, np.int32)
        steps = logmel_steps(self.fb_logmel, plan.lanes)
        self.filt_packed_logmel = row_major(steps.weights, device)
        self.fb_table_logmel = row_major(
            np.concatenate([self.fb_logmel.table, steps.steps]), device,
            np.int32)
        check_row_major(
            (self.plan_twiddle, self.fb_table, self.filt_packed_logmel,
             self.fb_table_logmel),
            ((len(plan.twiddle), 2), (len(fb.table),),
             (self.fb_logmel.chunk * plan.lanes,),
             (len(self.fb_logmel.table) + len(steps.steps),)))

    def fb_args(self, logmel_tail: bool) -> tuple:
        """(filt_packed, fb_table, n_packed, n_seg) of the filterbank plan a
        launch reads: the log-mel plan's for log-mel mode's tail, else the
        fused plan's."""
        if logmel_tail:
            return (self.filt_packed_logmel.data_ptr(),
                    self.fb_table_logmel.data_ptr(),
                    self.filt_packed_logmel.numel(), self.fb_logmel.n_seg)
        return (self.filt_packed.data_ptr(), self.fb_table.data_ptr(),
                len(self.fb.packed), self.fb.n_seg)

    def layout_for(self, p: ListenerParams, full_dct: bool = False,
                   cepstrum: bool = False, partial_sums: bool = False):
        """The register or wide block of `self.plan` at config p: fused
        (the trimmed DCT, or with full_dct the whole one) or in log-mel
        mode, its tail's or with partial_sums its first tail's
        (`fft_plan.fft_layout`)."""
        fb = self.fb_logmel if cepstrum and not partial_sums else self.fb
        return fft_layout(self.plan, fb, p.n_filt, p.n_mfcc, p.n_features,
                          full_dct=full_dct, cepstrum=cepstrum,
                          partial_sums=partial_sums)

    def dct_args(self, p: ListenerParams, full_dct: bool) -> tuple:
        """(pointer, dct_cols) of the fused epilogue's DCT table."""
        if full_dct:
            return self.dct_t.data_ptr(), p.n_filt
        return self.dct_trim.data_ptr(), p.n_mfcc - 1


def register_layout(consts, p: ListenerParams, full_dct: bool,
                    cepstrum: bool, partial_sums: bool = False):
    """The register or wide block a launch runs (`DctTables.layout_for`),
    or ValueError where that mode's block fits no shared memory (the
    `_full_dct` A/B at a config whose whole DCT leaves no room)."""
    lay = consts.layout_for(p, full_dct and not cepstrum, cepstrum,
                            partial_sums and cepstrum)
    if lay.smem_bytes > SMEM_OPTIN:
        raise ValueError(
            f"the {'whole' if full_dct else 'trimmed'} DCT of {p.n_filt} "
            f"filters leaves no block of the register FFT at n_fft "
            f"{p.n_fft} room: {lay.smem_bytes} bytes of shared memory, more "
            f"than {SMEM_OPTIN}")
    return lay


# the tails of the register and wide bodies' log-mel mode, as their launches
# name them (register_fft.cuh's Logmel): the shipped tail (filters
# finished where the walk ends them, each row staged and stored in 16-byte
# stores) and the first one (partial sums, a pass a filter; the A/B)
LOGMEL_ROWS, LOGMEL_PARTIAL = 1, 2


def logmel_buffer(audio: torch.Tensor, p: ListenerParams) -> torch.Tensor:
    """The (B, n_features, n_filt + 1) f32 rows the FFT body writes in
    log-mel mode: each kept frame's log-mel values, then its log energy."""
    return torch.empty((audio.shape[0], p.n_features, p.n_filt + 1),
                       dtype=torch.float32, device=audio.device)
