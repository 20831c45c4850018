"""The MFCC / bark frontend kernels: wrappers, launch counts and plain
versions, and the choice of route for a config.

`csrc/mfcc_frontend.cu` replaces the TPU kernel
`tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend` (and takes
the contract of the dense branch of `make_fused_frontend`): gain x audio
(int16 decoded as x/32768), framing, FFT power spectrum, mel or bark
filterbank, log, DCT, log-energy coefficient, optional deltas and the tail
trim to n_features, in one launch.  It has three bodies, chosen from the
config (`fft_body`): the register-resident real-input FFT with the packed
filterbank for n_fft 128 .. 4096 (`fft_plan.py` holds its plan); the same
body with a frame over four warps for n_fft 8192 and 16384
(`csrc/mfcc_wide_frontend.cu`, "wide"); and the shared-memory radix-2 FFT
for n_fft below 128 (and a config whose filterbank leaves the others no
room).  The register and wide bodies keep only the DCT columns the output
uses; where even those leave the block too little room
(`fft_plan.cepstrum_mode`: many filters and coefficients), the body runs in
log-mel mode and `csrc/cepstrum_wgmma.cu` (`cepstrum_cuda`, plan
`cepstrum_plan.py`) computes the DCT, the energy column, the deltas and the
store as a 3xTF32 GEMM on the tensor cores ("+cep" in
`MfccFrontend.path`); `csrc/cepstrum.cu`, its first design (FFMA),
computes the same function and runs with `_simt=True` for the A/B.

`csrc/dft_wgmma.cu` replaces the TPU kernel
`tpu_speech_commands/ops/pallas_frontend.py::make_fused_frontend` with
`fast_math=True` (the dense branch, pallas_call :340; and
`tools/dev/pallas_experiments.py::make_bf16_kernel`, the same contract): the
same chain with the DFT as a bf16 GEMM on the tensor cores (wgmma on a
TMA-fed ring, plan `dft_plan.py`), f32 accumulation, and an f32
filterbank, log and DCT; where many filters leave its block too few
windows or its DCT too many products (`dft_cepstrum`), it runs in log-mel
mode and the cepstrum kernel finishes ("+cep").  In log-mel mode a filter
that one quad lane's walk alone weighs leaves the block from that lane's
registers, and only the few boundary filters meet in shared memory
(`dft_plan.filter_homes`); its first log-mel design, every filter summed
in shared memory, runs with `_shared_sums=True` for the A/B.
`csrc/dft_frontend.cu`, its first design (mma.sync), computes the same
function; `_mma_sync=True` runs it for the A/B.

`MfccFrontend` dispatches on the tensor it is given: a CPU tensor goes
through the plain PyTorch chain (`frontend/dsp.py::Frontend`, with the same
`fast_math`), a CUDA tensor takes the route `frontend_route` chose for the
config when the frontend was built:
- "fft": n_fft a power of two, the FFT kernel (a window longer than n_fft
  is cut to its first n_fft samples, as np.fft.rfft(frame, n=n_fft) does),
  its register body for n_fft 128 .. 4096, its wide body at 8192 and 16384
  and its radix-2 body below 128 (`MfccFrontend.body` names it), the first
  two fused or with the cepstrum kernel (`MfccFrontend.cepstrum`);
- "ct": the configs the JAX package's CT kernel takes and the FFT kernel
  cannot, n_fft = 128 n2 (n2 even, not a power of two) == window: the
  mixed-radix register FFT (csrc/mixed_fft_frontend.cu) up to n_fft 4096,
  above it the same register body with a frame over two or four warps
  (csrc/wide_fft_frontend_*.cu), each fused or with the cepstrum kernel
  (`ct_kernel.ct_body`: "register", "wide"; the CT split kernel,
  csrc/ct_frontend.cu, is the A/B baseline);
- "torch": every other config (among them the powers of two from n_fft
  32768 that no body of the FFT kernel takes and that are not CT-eligible:
  window < n_fft), which the JAX scorer, too, serves with plain XLA
  products outside any Pallas kernel: the plain chain on the card.
The fast_math DFT kernel needs a hop that is a multiple of 8 samples and at
most 128 kept frames.  A config a kernel route cannot take raises
ValueError on CUDA; nothing falls back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..frontend.dsp import Frontend
from ..frontend.filterbanks import dft_matrices, filterbank_matrix
from ..params import ListenerParams, pr
from . import _build, cepstrum_plan
from ._checks import OUT_DTYPES, check_launch, check_row_major, row_major
from .ct_constants import ct_eligible
from .ct_kernel import (CtConstants, ct_body, ct_cepstrum, ct_config_error,
                        ct_frontend_cuda)
from .dft_plan import (WGMMA_STAGES, column_order, filter_homes,
                       filter_slots, wgmma_rows, wgmma_smem_bytes,
                       wgmma_table_bytes)
from .fft_plan import (SMEM_OPTIN, cepstrum_mode,
                       fft_layout, fft_plan,
                       fft_wide_plan, filterbank_plan, pack_filterbank,
                       takes_fft_wide, takes_register_fft)
from .launch_count import LOGMEL, PARTIAL_SUMS, LaunchCount

SOURCE = "tpu_speech_commands_torch/csrc/mfcc_frontend.cu"
WIDE_SOURCE = "tpu_speech_commands_torch/csrc/mfcc_wide_frontend.cu"
CEPSTRUM_SOURCE = "tpu_speech_commands_torch/csrc/cepstrum_wgmma.cu"
CEPSTRUM_SIMT_SOURCE = "tpu_speech_commands_torch/csrc/cepstrum.cu"
REPLACES = "tpu_speech_commands/ops/pallas_frontend.py:745"
DFT_SOURCE = "tpu_speech_commands_torch/csrc/dft_wgmma.cu"
DFT_MMA_SYNC_SOURCE = "tpu_speech_commands_torch/csrc/dft_frontend.cu"
DFT_REPLACES = "tpu_speech_commands/ops/pallas_frontend.py:340"

# tsc_mfcc_frontend(audio, audio_int16, gain, batch, n_samples, window, hop,
#   n_fft, first_frame, n_features, twiddle, filt_t, dct_t, dct_cols,
#   n_filt, n_mfcc, emit_deltas, out, out_bf16, plan_twiddle, filt_packed,
#   fb_table, n_packed, n_seg, radix2, logmel, stream)
_N_ARGS = 27
_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 13, 14, 15, 16, 18, 22, 23, 24, 25)
# tsc_mfcc_wide_frontend(audio, audio_int16, gain, batch, n_samples, window,
#   hop, n_fft, first_frame, n_features, plan_twiddle, filt_packed,
#   fb_table, n_packed, n_seg, dct_t, dct_cols, n_filt, n_mfcc, emit_deltas,
#   n_warps, out, out_bf16, logmel, stream)
_WIDE_N_ARGS = 25
_WIDE_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 13, 14, 16, 17, 18, 19, 20, 22, 23)
# tsc_cepstrum(logmel, batch, n_features, n_filt, n_mfcc, table_hi,
#   table_lo, k_pad, n_pad, n_tile, windows_per_block, emit_deltas,
#   time_major, out, out_bf16, stream)
_CEP_N_ARGS = 16
_CEP_INT_ARGS = (1, 2, 3, 4, 7, 8, 9, 10, 11, 12, 14)
# tsc_cepstrum_simt(logmel, batch, n_features, n_filt, n_mfcc, table, k_pad,
#   n_pad, windows_per_block, emit_deltas, time_major, out, out_bf16, stream)
_CEP_SIMT_N_ARGS = 14
_CEP_SIMT_INT_ARGS = (1, 2, 3, 4, 6, 7, 8, 9, 10, 12)

# tsc_dft_frontend_bf16(audio, audio_int16, gain, batch, n_samples, hop,
#   first_frame, n_features, wpb, n_seg, seg_pitch, win_pitch, dft, k_pad,
#   n_pad, n_bins, n_fft, filt_packed, n_packed, filt_range, dct_t, n_filt,
#   n_mfcc, emit_deltas, out, out_bf16, stream)
_DFT_N_ARGS = 27
_DFT_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 18, 21, 22,
                 23, 25)
# tsc_dft_frontend_wgmma(audio, audio_int16, gain, batch, n_samples, hop,
#   first_frame, n_features, wpb, n_seg, seg_pitch, win_pitch, dft, k_pad,
#   n_pad, n_fft, bin_key, bin_w, slots, table_smem, stages, filt_packed,
#   filt_range, dct_t, n_filt, n_mfcc, emit_deltas, logmel, shared_sums,
#   filt_home, tail_filt, n_bnd, n_tail, out, out_bf16, stream)
_WGMMA_N_ARGS = 36
_WGMMA_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 18, 19, 20, 24,
                   25, 26, 27, 28, 31, 32, 34)
# csrc/dft_frontend.cu's tile (the mma.sync kernel): GEMM rows (frames) a
# block, DFT columns a chunk, the K-slice, the B-stage row pitch and the
# B-stage count.  Both kernels take 128 rows a block and the K padded to
# 128 (two of the wgmma kernel's 64-deep slices).
DFT_BM, DFT_BN, DFT_BK, DFT_BKP, DFT_STAGES = 128, 128, 64, 72, 2
# shared memory a block may opt in to on an H100 (227 KB)
DFT_SMEM_MAX = 232448


def frontend_route(p: ListenerParams, feature_type: str = "mfcc") -> str:
    """The route `MfccFrontend` takes on CUDA for config `p` (fast_math
    aside): "fft" where n_fft is a power of two that a body of the FFT
    kernel takes, "ct" where the JAX package's CT kernel takes the config
    (`ct_eligible`), else "torch".  A power of two no body takes (from n_fft
    32768 the radix-2 body's one-warp block exceeds shared memory, and the
    register and wide bodies have no plan) takes "torch" where it is not
    CT-eligible: the JAX scorer serves it with plain XLA products, and so
    does this route.  Where it is CT-eligible (window = n_fft), the JAX
    scorer runs its CT kernel, which the port has no plan for above 15872:
    it stays on route "fft", whose kernel refuses it
    (`kernel_config_error`).  Chosen from the config, before anything
    launches."""
    n_fft = p.n_fft
    if n_fft >= 2 and not n_fft & (n_fft - 1):
        if fft_body(p, feature_type) == "radix2" and \
                radix2_smem_bytes(p) > SMEM_OPTIN and not ct_eligible(p):
            return "torch"
        return "fft"
    return "ct" if ct_eligible(p) else "torch"


def _register_plan(p: ListenerParams, feature_type: str):
    """The register or wide body's plan and filterbank plan for config
    `p`."""
    plan = fft_plan(p.n_fft) if takes_register_fft(p.n_fft) else \
        fft_wide_plan(p.n_fft)
    return plan, filterbank_plan(filterbank_matrix(p, feature_type).T,
                                 plan.lanes)


def fft_body(p: ListenerParams, feature_type: str = "mfcc") -> str:
    """Which body of the FFT kernel takes config `p` (route "fft"):
    "register" for n_fft 128 .. 4096 and "wide" for 8192 and 16384 where
    its block fits, fused or in log-mel mode (`fft_cepstrum`), "radix2" for
    every other power of two (and a config whose filterbank leaves the
    register or wide body no room even in log-mel mode).  Chosen from the
    config, never from a failed launch."""
    if takes_register_fft(p.n_fft):
        body = "register"
    elif takes_fft_wide(p.n_fft):
        body = "wide"
    else:
        return "radix2"
    lay = fft_layout(*_register_plan(p, feature_type), p.n_filt, p.n_mfcc,
                     p.n_features, cepstrum=True)
    return body if lay.smem_bytes <= SMEM_OPTIN else "radix2"


def fft_cepstrum(p: ListenerParams, feature_type: str = "mfcc") -> bool:
    """Whether route fft runs config `p` through the cepstrum kernel: its
    register or wide body in log-mel mode, then csrc/cepstrum_wgmma.cu
    (`fft_plan.cepstrum_mode`); never on the radix-2 body."""
    if fft_body(p, feature_type) == "radix2":
        return False
    return cepstrum_mode(*_register_plan(p, feature_type), p.n_filt,
                         p.n_mfcc, p.n_features)


def radix2_smem_bytes(p: ListenerParams, warps: int = 1) -> int:
    """The radix-2 body's shared memory at config `p` (radix2_smem_bytes()
    of csrc/mfcc_frontend.cu): a buffer of n_fft float2 and n_filt log-mel
    values a warp, and the window's coefficients."""
    return 8 * warps * p.n_fft + 4 * (warps * p.n_filt
                                      + p.n_features * p.n_mfcc)


def kernel_config_error(p: ListenerParams, feature_type: str = "mfcc",
                        body: str | None = None) -> str | None:
    """Why the FFT kernel cannot take config `p`, or None when it can;
    `body`, where given, is the body the launch runs (else `fft_body`'s)."""
    n_fft = p.n_fft
    if n_fft < 2 or n_fft & (n_fft - 1):
        return f"the CUDA frontend kernel needs n_fft a power of two, got {n_fft}"
    if p.n_mfcc > p.n_filt:
        return (
            f"the CUDA frontend kernel needs n_mfcc <= n_filt, got "
            f"{p.n_mfcc} > {p.n_filt}"
        )
    if radix2_smem_bytes(p) > SMEM_OPTIN and \
            (body or fft_body(p, feature_type)) == "radix2":
        return (f"no body of the CUDA frontend kernel takes n_fft {n_fft} "
                f"with {p.n_filt} filters: the radix-2 body's one-warp "
                f"block needs {radix2_smem_bytes(p)} bytes of shared memory, "
                f"more than {SMEM_OPTIN}")
    return None


class KernelConstants(cepstrum_plan.DctTables):
    """Device-resident constants of the FFT kernel for one config.  Every
    body: the DCT tables (`DctTables`).  The radix-2 body: twiddles
    exp(-2 pi i k / n_fft), k < n_fft / 2, built in float64 and stored as
    float32 (cos, sin) rows, and the filterbank transposed to (n_filt,
    n_bins).  `body` is `fft_body`'s; where it is "register" or "wide"
    (else None): the register body's tables, `cepstrum` and `layout`
    (`DctTables.stage_register`: the twiddles, the fused filterbank plan's
    and log-mel mode's step tables, the mode and its block)."""

    def __init__(self, p: ListenerParams, feature_type: str, device):
        super().__init__(p, device)
        k = np.arange(p.n_fft // 2, dtype=np.float64)
        ang = -2.0 * np.pi * k / p.n_fft
        filt_t = filterbank_matrix(p, feature_type).T
        self.twiddle = row_major(np.stack([np.cos(ang), np.sin(ang)], axis=-1),
                                 device)
        self.filt_t = row_major(filt_t, device)
        self.device = self.twiddle.device  # with its index: cuda -> cuda:0
        check_row_major((self.twiddle, self.filt_t),
                        ((p.n_fft // 2, 2), (p.n_filt, p.n_fft_bins)))
        self.plan = self.fb = self.layout = None
        self.plan_twiddle = self.filt_packed = self.fb_table = None
        self.cepstrum = False
        self.body = fft_body(p, feature_type)
        if self.body != "radix2":
            self.stage_register(*_register_plan(p, feature_type), p, device)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class DftLayout:
    """How a fast_math kernel tiles one config (`csrc/dft_wgmma.cu`, or
    with mma_sync `csrc/dft_frontend.cu`: they differ in wpb and
    smem_bytes).

    The DFT matrix is (n_pad, k_pad): k_eff = min(window, n_fft) rows of the
    DFT (longer windows meet zero rows) padded to 128, and 2 x n_bins
    columns padded to 16.  Each window's audio is staged in shared memory
    as n_seg segments of one hop, seg_pitch = hop + pad elements apart, so
    that 8 consecutive frames start in 8 distinct 16-byte bank groups; wpb
    windows a block, win_pitch elements apart.  The wgmma kernel's matrix
    has wgmma_rows rows (`dft_plan.wgmma_rows`), its ring `stages` B
    stages (5 where they fit, else 4; wpb is chosen at 4), and table_smem
    says whether its filter slots fit in shared memory beside the rest,
    else it reads them from the device's copy; `logmel`: the block of its
    log-mel mode (no DCT region; its shared sums only the `n_bnd` boundary
    filters' of `dft_plan.filter_homes`, unless `shared_sums`, the first
    log-mel design's every filter sum)."""

    k_eff: int
    k_pad: int
    n_bins: int
    n_pad: int
    seg_pitch: int
    n_seg: int
    win_pitch: int
    wpb: int
    smem_bytes: int
    table_smem: bool = False
    stages: int = 4
    wgmma_rows: int = 0
    logmel: bool = False
    shared_sums: bool = False
    n_bnd: int = 0


def _dft_smem_bytes(wpb, win_pitch, n_filt, n_mfcc, k_pad, n_packed) -> int:
    """Mirrors smem_bytes() in csrc/dft_frontend.cu."""
    return (_round_up(2 * wpb * win_pitch, 16)
            + _round_up(2 * DFT_STAGES * DFT_BN * DFT_BKP, 16)
            + _round_up(4 * DFT_BM * max(n_mfcc, DFT_BN // 2 + 1), 16)
            + _round_up(4 * DFT_BM * ((n_filt + 1) | 1), 16)
            + _round_up(4 * (k_pad // 8), 16)
            + _round_up(4 * n_packed, 16)
            + _round_up(4 * 3 * n_filt, 16)
            + _round_up(4 * n_filt * n_filt, 16))


def dft_layout(p: ListenerParams, feature_type: str = "mfcc",
               mma_sync: bool = False, logmel: bool = False,
               shared_sums: bool = False) -> DftLayout:
    """The layout of the wgmma kernel (fused, or with logmel in its log-mel
    mode, with shared_sums its first log-mel design), or with mma_sync of
    the first design, at config p: the most windows a block (up to 128
    rows) whose shared memory fits."""
    filt_t = filterbank_matrix(p, feature_type).T
    n_packed = len(pack_filterbank(filt_t)[0])
    hop = p.hop_samples
    k_eff = min(p.window_samples, p.n_fft)
    k_pad = _round_up(k_eff, 2 * DFT_BK)
    pad = 8 if (hop // 8) % 2 == 0 else 16  # (hop + pad) / 8 odd
    seg_pitch = hop + pad
    n_seg = -(-((p.n_features - 1) * hop + k_pad) // hop)
    win_pitch = n_seg * seg_pitch
    if (win_pitch // 8) % 2 == 0:
        win_pitch += 8
    wpb = max(1, DFT_BM // p.n_features)
    n_pad = _round_up(2 * p.n_fft_bins, 16)
    rows = wgmma_rows(n_pad)
    logmel = logmel and not mma_sync
    shared_sums = logmel and shared_sums
    slots = n_bnd = None
    if not mma_sync:
        slots = filter_slots(filt_t, rows // 2)
        n_bnd = filter_homes(slots, p.n_filt, rows).n_bnd \
            if logmel and not shared_sums else 0

    def smem(wpb, **kw):
        if mma_sync:
            return _dft_smem_bytes(wpb, win_pitch, p.n_filt, p.n_mfcc, k_pad,
                                   n_packed)
        return wgmma_smem_bytes(wpb, win_pitch, p.n_filt, p.n_mfcc, k_pad,
                                n_features=p.n_features, logmel=logmel,
                                shared_sums=shared_sums, n_bnd=n_bnd, **kw)

    while wpb > 1 and smem(wpb) > DFT_SMEM_MAX:
        wpb -= 1
    nbytes, table, stages = smem(wpb), False, DFT_STAGES
    if not mma_sync:
        stages = max([st for st in WGMMA_STAGES
                      if smem(wpb, stages=st) <= DFT_SMEM_MAX]
                     or [WGMMA_STAGES[0]])
        nbytes = smem(wpb, stages=stages)
        extra = wgmma_table_bytes(rows, slots.slots)
        table = nbytes + extra <= DFT_SMEM_MAX
        nbytes += extra if table else 0
    return DftLayout(
        k_eff=k_eff, k_pad=k_pad, n_bins=p.n_fft_bins, n_pad=n_pad,
        seg_pitch=seg_pitch, n_seg=n_seg, win_pitch=win_pitch, wpb=wpb,
        smem_bytes=nbytes, table_smem=table, stages=stages,
        wgmma_rows=rows, logmel=logmel, shared_sums=shared_sums,
        n_bnd=n_bnd or 0)


# The fused DCT's products a frame, n_filt (n_mfcc - 1), from which the
# wgmma kernel runs in log-mel mode with the cepstrum kernel even where its
# fused block holds as many windows (its fused DCT runs on the CUDA cores
# after the last chunk, with nothing to overlap it): the fused / log-mel
# sweep at n_fft 1024, where both blocks hold 4 windows
# (`dev/logmel_ablation.py --parts dft`, in turns, 10 launches a turn, B =
# 8192, two runs) found log-mel mode 4.2% and 4.4% faster at 48 x 20 (912
# products), 8.1% and 6.7% at 64 x 20, and within 1.3% of fused at 32 x 20
# and 40 x 13 (608, 480).
DFT_CEP_MIN_PRODUCTS = 912


def dft_cepstrum(p: ListenerParams, feature_type: str = "mfcc") -> bool:
    """Whether the wgmma kernel runs config `p` in log-mel mode with the
    cepstrum kernel after it, by `fft_plan.cepstrum_mode`'s rule on its own
    blocks and its own threshold: where its fused block (the trimmed DCT)
    does not fit, holds fewer windows than the log-mel block, or has
    DFT_CEP_MIN_PRODUCTS or more DCT products a frame."""
    fused = dft_layout(p, feature_type)
    if fused.smem_bytes > DFT_SMEM_MAX:
        return True
    return (fused.wpb < dft_layout(p, feature_type, logmel=True).wpb
            or p.n_filt * (p.n_mfcc - 1) >= DFT_CEP_MIN_PRODUCTS)


def dft_config_error(p: ListenerParams, feature_type: str = "mfcc",
                     mma_sync: bool = False,
                     layout: DftLayout | None = None) -> str | None:
    """Why the fast_math DFT kernel (the wgmma one, or with mma_sync the
    first design) cannot take config `p`, or None; `layout`, where given,
    is that kernel's `dft_layout` at p (the launch passes its constants'
    layout rather than build it anew; else the layout of the mode
    `dft_cepstrum` chooses).  The wgmma kernel's shared memory at one
    window a block is never more than the first design's, so it takes
    every config that one takes."""
    if p.hop_samples % 8:
        return ("the CUDA fast_math frontend kernel needs hop_samples a "
                f"multiple of 8, got {p.hop_samples}")
    if p.n_features > DFT_BM:
        return ("the CUDA fast_math frontend kernel takes at most "
                f"{DFT_BM} frames a window, got {p.n_features}")
    if p.n_mfcc > p.n_filt:
        return (f"the CUDA fast_math frontend kernel needs n_mfcc <= n_filt, "
                f"got {p.n_mfcc} > {p.n_filt}")
    smem = (layout or dft_layout(
        p, feature_type, mma_sync,
        not mma_sync and dft_cepstrum(p, feature_type))).smem_bytes
    if smem > DFT_SMEM_MAX:
        return (f"one window of this config needs {smem} bytes of shared "
                f"memory in the CUDA fast_math frontend kernel, more than "
                f"{DFT_SMEM_MAX}")
    return None


def dft_bf16_matrix(p: ListenerParams, layout: DftLayout) -> np.ndarray:
    """(n_pad, k_pad) float32 DFT matrix, rows 2k and 2k + 1 the cos and sin
    of bin k over the frame's samples, zero-padded; the kernel takes it
    rounded to bf16."""
    cos, sin = dft_matrices(p.window_samples, p.n_fft)
    m = np.zeros((layout.n_pad, layout.k_pad), np.float32)
    m[0:2 * layout.n_bins:2, :layout.k_eff] = cos[:layout.k_eff].T
    m[1:2 * layout.n_bins:2, :layout.k_eff] = sin[:layout.k_eff].T
    return m


class DftConstants(cepstrum_plan.DctTables):
    """Device-resident constants of the fast_math DFT kernels for one
    config: the bf16 cos|sin matrix (`dft_bf16_matrix`), the transposed
    filterbank packed to its nonzero ranges (`pack_filterbank`) and as the
    wgmma kernel's filter slots over n_pad / 2 bins (`dft_plan.
    filter_slots`: `bin_key`, `bin_w`, `slots`), the DCT tables
    (`DctTables`: the whole table the mma.sync kernel reads, the trimmed
    columns of the wgmma kernel's fused mode, the cepstrum kernel's),
    log-mel mode's home codes and tail filters (`dft_plan.filter_homes`:
    `filt_home`, `tail_filt`, `n_bnd`); the wgmma kernel's mode
    (`cepstrum`, `dft_cepstrum`) and the layouts of both kernels (`layout`,
    that mode's; `layouts`, each mode's; `shared_sums_layout`, the first
    log-mel design's; `mma_sync_layout`).  The wgmma kernel takes the
    matrix's rows in `dft_plan.column_order` (`dft_wgmma`), the mma.sync
    kernel in the natural order (`dft`)."""

    def __init__(self, p: ListenerParams, feature_type: str, device):
        super().__init__(p, device)
        self.feature_type = feature_type
        self.cepstrum = dft_cepstrum(p, feature_type)
        self.layouts = {mode: dft_layout(p, feature_type, logmel=mode)
                        for mode in (False, True)}
        self.layout = self.layouts[self.cepstrum]
        self.shared_sums_layout = dft_layout(p, feature_type, logmel=True,
                                             shared_sums=True)
        self.mma_sync_layout = dft_layout(p, feature_type, mma_sync=True)
        matrix = dft_bf16_matrix(p, self.layout)
        self.dft = row_major(matrix, device).to(torch.bfloat16)
        order = column_order(self.layout.n_pad)  # rows past n_pad: zero
        padded = np.zeros((self.layout.wgmma_rows, self.layout.k_pad),
                          np.float32)
        padded[:self.layout.n_pad] = matrix
        self.dft_wgmma = row_major(padded[order], device).to(torch.bfloat16)
        filt_t = filterbank_matrix(p, feature_type).T
        packed, ranges = pack_filterbank(filt_t)
        self.filt_packed = row_major(packed, device)
        self.filt_range = row_major(ranges, device, np.int32)
        slots = filter_slots(filt_t, self.layout.wgmma_rows // 2)
        self.slots = slots.slots
        self.bin_key = row_major(slots.key, device, np.int32)
        self.bin_w = row_major(slots.w, device)
        homes = filter_homes(slots, p.n_filt, self.layout.wgmma_rows)
        self.filt_home = row_major(homes.home, device, np.uint8)
        self.tail_filt = row_major(homes.tail, device, np.int32)
        self.n_bnd = homes.n_bnd
        self.device = self.dft.device
        lay = self.layout
        check_row_major(
            (self.dft, self.dft_wgmma, self.filt_packed, self.filt_range,
             self.bin_key, self.bin_w, self.dct_t, self.filt_home,
             self.tail_filt),
            ((lay.n_pad, lay.k_pad), (lay.wgmma_rows, lay.k_pad),
             (len(packed),), (p.n_filt, 3),
             (lay.wgmma_rows // 2,), (lay.wgmma_rows // 2, self.slots),
             (p.n_filt, p.n_filt), (p.n_filt,), (len(homes.tail),)))


def mfcc_frontend_cuda(audio: torch.Tensor, gain: torch.Tensor,
                       consts: KernelConstants, p: ListenerParams,
                       out_dtype=torch.float32, *, _radix2: bool = False,
                       _full_dct: bool = False,
                       _cepstrum: bool | None = None,
                       _cepstrum_simt: bool = False,
                       _partial_sums: bool = False) -> torch.Tensor:
    """Launch the frontend kernel.  audio (B, S) float32 or int16 and gain
    (1,) float32, both on consts' CUDA device -> (B, n_features,
    feature_size) out_dtype.  The body is `consts.body`, fused or, where
    `consts.cepstrum`, in log-mel mode (`fft_logmel_cuda`) with the
    cepstrum kernel after it (`cepstrum_cuda`).  The same-call A/Bs:
    `_radix2` sends a config the register or wide body takes to the radix-2
    body; `_full_dct` runs the fused epilogue on the whole n_filt x n_filt
    DCT; `_cepstrum` (True or False) forces the mode; `_partial_sums` runs
    log-mel mode's first tail; `_cepstrum_simt` finishes log-mel mode with
    the cepstrum kernel's first design.  A launch of the register body adds
    one to `.launches`, one of the wide body to `WIDE.launches`, one of the
    radix-2 body to `RADIX2.launches` (and in log-mel mode one to
    `LOGMEL.launches` or `PARTIAL_SUMS.launches`, the cepstrum kernel's to
    `CEPSTRUM.launches`, its first design's to `CEPSTRUM_SIMT`)."""
    radix2 = _radix2 or consts.plan is None
    err = kernel_config_error(p, body="radix2" if radix2 else consts.body)
    if err:
        raise ValueError(err)
    cepstrum = not radix2 and (consts.cepstrum if _cepstrum is None
                               else _cepstrum)
    if cepstrum:
        check_launch(audio, gain, consts.device, p, out_dtype)
        rows = fft_logmel_cuda(audio, gain, consts, p,
                               _partial_sums=_partial_sums)
        return cepstrum_cuda(rows, consts.cep_table, p.n_mfcc, p.use_delta,
                             out_dtype=out_dtype, _simt=_cepstrum_simt)
    lay = None if radix2 else cepstrum_plan.register_layout(
        consts, p, _full_dct, False)
    n_frames = check_launch(audio, gain, consts.device, p, out_dtype)
    shape = (audio.shape[0], p.n_features, p.feature_size)
    out = torch.empty(shape, dtype=out_dtype, device=audio.device)
    if audio.shape[0]:
        _launch_fft(audio, gain, consts, p, n_frames, out, radix2, _full_dct,
                    0, lay)
    return out


def fft_logmel_cuda(audio: torch.Tensor, gain: torch.Tensor,
                    consts: KernelConstants, p: ListenerParams, *,
                    _partial_sums: bool = False) -> torch.Tensor:
    """Launch route fft's register or wide body in log-mel mode: audio (B,
    S) float32 or int16 and gain (1,) float32 on consts' CUDA device -> the
    (B, n_features, n_filt + 1) f32 log-mel rows, the log energy last (the
    plain version: `cepstrum_plan.logmel_plain`).  `_partial_sums` runs the
    mode's first tail, the same-call A/B.  A launch adds one to its body's
    count and to `LOGMEL.launches` (`PARTIAL_SUMS.launches`)."""
    if consts.plan is None:
        raise ValueError(f"no register or wide body takes n_fft {p.n_fft} "
                         f"with {p.n_filt} filters: no log-mel mode")
    err = kernel_config_error(p, body=consts.body)
    if err:
        raise ValueError(err)
    lay = cepstrum_plan.register_layout(consts, p, False, True,
                                        _partial_sums)
    n_frames = check_launch(audio, gain, consts.device, p, torch.float32)
    out = cepstrum_plan.logmel_buffer(audio, p)
    if audio.shape[0]:
        _launch_fft(audio, gain, consts, p, n_frames, out, False, False,
                    cepstrum_plan.LOGMEL_PARTIAL if _partial_sums
                    else cepstrum_plan.LOGMEL_ROWS, lay)
        (PARTIAL_SUMS if _partial_sums else LOGMEL).launches += 1
    return out


def _launch_fft(audio, gain, consts: KernelConstants, p: ListenerParams,
                n_frames: int, out: torch.Tensor, radix2: bool,
                full_dct: bool, logmel: int, lay):
    """One launch of the body `consts.body` (or, with radix2, the radix-2
    body) into `out`: fused, or with logmel (LOGMEL_ROWS or
    LOGMEL_PARTIAL) the log-mel rows; its launch count."""
    batch, n_samples = audio.shape
    dct_ptr, dct_cols = consts.dct_args(p, full_dct or radix2)
    out_bf16 = int(out.dtype == torch.bfloat16)
    if consts.body == "wide" and not radix2:
        fn = _build.bind("tsc_mfcc_wide_frontend", _WIDE_N_ARGS,
                         _WIDE_INT_ARGS)
        with torch.cuda.device(audio.device):
            stream = torch.cuda.current_stream(audio.device).cuda_stream
            rc = fn(
                audio.data_ptr(), int(audio.dtype == torch.int16),
                gain.data_ptr(), batch, n_samples, p.window_samples,
                p.hop_samples, p.n_fft, n_frames - p.n_features, p.n_features,
                consts.plan_twiddle.data_ptr(),
                *consts.fb_args(logmel == cepstrum_plan.LOGMEL_ROWS), dct_ptr,
                dct_cols, p.n_filt, p.n_mfcc, int(p.use_delta), lay.warps,
                out.data_ptr(), out_bf16, logmel, stream,
            )
        _build.check(rc, "tsc_mfcc_wide_frontend")
        WIDE.launches += 1
        return
    fn = _build.bind("tsc_mfcc_frontend", _N_ARGS, _INT_ARGS)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        plan_args = (0, 0, 0, 0, 0) if consts.plan is None else (
            consts.plan_twiddle.data_ptr(),
            *consts.fb_args(logmel == cepstrum_plan.LOGMEL_ROWS))
        rc = fn(
            audio.data_ptr(), int(audio.dtype == torch.int16),
            gain.data_ptr(), batch, n_samples, p.window_samples,
            p.hop_samples, p.n_fft, n_frames - p.n_features, p.n_features,
            consts.twiddle.data_ptr(), consts.filt_t.data_ptr(),
            dct_ptr, dct_cols, p.n_filt, p.n_mfcc, int(p.use_delta),
            out.data_ptr(), out_bf16, *plan_args, int(radix2), logmel, stream,
        )
    _build.check(rc, "tsc_mfcc_frontend")
    if radix2:
        RADIX2.launches += 1
    else:
        mfcc_frontend_cuda.launches += 1


mfcc_frontend_cuda.launches = 0
RADIX2 = LaunchCount()  # launches of the radix-2 body
WIDE = LaunchCount()  # launches of the wide body (n_fft 8192, 16384)
CEPSTRUM = LaunchCount()  # launches of the cepstrum kernel (both routes)
CEPSTRUM_SIMT = LaunchCount()  # launches of its first design (`_simt=True`)


def cepstrum_cuda(logmel: torch.Tensor, tables: cepstrum_plan.CepTables,
                  n_mfcc: int, emit_deltas: bool = False,
                  time_major: bool = False, out_dtype=torch.float32, *,
                  _simt: bool = False) -> torch.Tensor:
    """Launch the cepstrum kernel (csrc/cepstrum_wgmma.cu): the (B, T, n_filt
    + 1) f32 log-mel rows of the FFT body's log-mel mode and the DCT's
    tables (`cepstrum_plan.cep_tables` of n_mfcc columns), all on one CUDA
    device -> (B, T, F), or (T, B, F) when time_major, F = n_mfcc or, with
    emit_deltas, 2 n_mfcc, in out_dtype; its plain version is
    `cepstrum_plan.cepstrum_plain`.  `_simt` runs the first design
    (csrc/cepstrum.cu, FFMA) instead, the same-call A/B.  A launch adds one
    to `CEPSTRUM.launches`, one of the first design to
    `CEPSTRUM_SIMT.launches`; a CPU tensor raises, and so does a shape the
    kernel cannot take."""
    if not logmel.is_cuda or any(t.device != logmel.device for t in tables):
        raise ValueError(f"the cepstrum kernel takes CUDA tensors on one "
                         f"device, got {logmel.device} and "
                         f"{[str(t.device) for t in tables]}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if (logmel.dtype != torch.float32 or not logmel.is_contiguous()
            or logmel.ndim != 3 or not 0 < n_mfcc < logmel.shape[2]):
        raise ValueError(f"log-mel rows must be a contiguous f32 (B, T, "
                         f"n_filt + 1) with n_mfcc <= n_filt, got "
                         f"{logmel.dtype} {tuple(logmel.shape)}, n_mfcc "
                         f"{n_mfcc}")
    batch, n_feat, n_filt = logmel.shape[0], logmel.shape[1], \
        logmel.shape[2] - 1
    if _simt:
        k_pad, n_pad = cepstrum_plan.padded_shape(n_filt, n_mfcc)
        check_row_major((tables.ext,), ((k_pad, n_pad),))
    else:
        n_pad, k_pad = cepstrum_plan.table_shape(n_filt, n_mfcc)
        check_row_major((tables.hi, tables.lo), ((n_pad, k_pad),) * 2)
        if tables.hi.data_ptr() % 16 or tables.lo.data_ptr() % 16:
            raise ValueError("the cepstrum kernel's tables must be 16-byte "
                             "aligned (its TMA reads them)")
    width = 2 * n_mfcc if emit_deltas else n_mfcc
    shape = (n_feat, batch, width) if time_major else (batch, n_feat, width)
    out = torch.empty(shape, dtype=out_dtype, device=logmel.device)
    if out.numel() == 0:
        return out
    wpb = cepstrum_plan.windows_per_block(n_feat)
    tail = (wpb, int(emit_deltas), int(time_major), out.data_ptr(),
            int(out_dtype == torch.bfloat16))
    with torch.cuda.device(logmel.device):
        stream = torch.cuda.current_stream(logmel.device).cuda_stream
        if _simt:
            name = "tsc_cepstrum_simt"
            fn = _build.bind(name, _CEP_SIMT_N_ARGS, _CEP_SIMT_INT_ARGS)
            rc = fn(logmel.data_ptr(), batch, n_feat, n_filt, n_mfcc,
                    tables.ext.data_ptr(), k_pad, n_pad, *tail, stream)
        else:
            name = "tsc_cepstrum"
            fn = _build.bind(name, _CEP_N_ARGS, _CEP_INT_ARGS)
            rc = fn(logmel.data_ptr(), batch, n_feat, n_filt, n_mfcc,
                    tables.hi.data_ptr(), tables.lo.data_ptr(), k_pad, n_pad,
                    cepstrum_plan.n_tile(n_mfcc), *tail, stream)
    _build.check(rc, name)
    (CEPSTRUM_SIMT if _simt else CEPSTRUM).launches += 1
    return out


def dft_frontend_bf16_cuda(audio: torch.Tensor, gain: torch.Tensor,
                           consts: DftConstants, p: ListenerParams,
                           out_dtype=torch.float32, *,
                           _mma_sync: bool = False,
                           _cepstrum: bool | None = None,
                           _shared_sums: bool = False) -> torch.Tensor:
    """Launch the fast_math (bf16 tensor-core DFT) frontend kernel, the
    wgmma one (csrc/dft_wgmma.cu).  audio (B, S) float32 or int16 and gain
    (1,) float32, both on consts' CUDA device -> (B, n_features,
    feature_size) out_dtype.  Fused, or where `consts.cepstrum` in log-mel
    mode (`dft_logmel_cuda`) with the cepstrum kernel after it
    (`cepstrum_cuda`).  The same-call A/Bs: `_cepstrum` (True or False)
    forces the mode; `_shared_sums` runs log-mel mode's first design;
    `_mma_sync` runs the first design (csrc/dft_frontend.cu, fused only)
    instead.  A launch of the wgmma kernel adds one to `.launches` (and in
    log-mel mode one to `DFT_LOGMEL.launches`, or to
    `DFT_SHARED_SUMS.launches` in its first design), one of the mma.sync
    kernel to `MMA_SYNC.launches`."""
    cepstrum = not _mma_sync and (consts.cepstrum if _cepstrum is None
                                  else _cepstrum)
    if cepstrum:
        check_launch(audio, gain, consts.device, p, out_dtype)
        return cepstrum_cuda(dft_logmel_cuda(audio, gain, consts, p,
                                             _shared_sums=_shared_sums),
                             consts.cep_table, p.n_mfcc, p.use_delta,
                             out_dtype=out_dtype)
    lay = consts.mma_sync_layout if _mma_sync else consts.layouts[False]
    err = dft_config_error(p, consts.feature_type, _mma_sync, lay)
    if err:
        raise ValueError(err)
    n_frames = check_launch(audio, gain, consts.device, p, out_dtype)
    out = torch.empty((audio.shape[0], p.n_features, p.feature_size),
                      dtype=out_dtype, device=audio.device)
    if audio.shape[0]:
        _dft_launch(audio, gain, consts, p, n_frames, out, lay, _mma_sync)
    return out


def dft_logmel_cuda(audio: torch.Tensor, gain: torch.Tensor,
                    consts: DftConstants, p: ListenerParams, *,
                    _shared_sums: bool = False) -> torch.Tensor:
    """Launch the wgmma kernel in log-mel mode: audio (B, S) float32 or
    int16 and gain (1,) float32 on consts' CUDA device -> the (B,
    n_features, n_filt + 1) f32 log-mel rows, the log energy last (the
    plain version: `cepstrum_plan.logmel_plain` on the fast_math chain).
    `_shared_sums` runs the mode's first design (every filter summed in
    shared memory), the same-call A/B.  A launch adds one to
    `dft_frontend_bf16_cuda.launches` and to `DFT_LOGMEL.launches`
    (`DFT_SHARED_SUMS.launches`)."""
    lay = consts.shared_sums_layout if _shared_sums else consts.layouts[True]
    err = dft_config_error(p, consts.feature_type, False, lay)
    if err:
        raise ValueError(err)
    n_frames = check_launch(audio, gain, consts.device, p, torch.float32)
    out = cepstrum_plan.logmel_buffer(audio, p)
    if audio.shape[0]:
        _dft_launch(audio, gain, consts, p, n_frames, out, lay, False)
    return out


def _dft_launch(audio, gain, consts: DftConstants, p: ListenerParams,
                n_frames: int, out: torch.Tensor, lay: DftLayout,
                mma_sync: bool):
    """One launch of the wgmma kernel (in `lay`'s mode) or with mma_sync of
    the first design into `out`; its launch counts."""
    batch, n_samples = audio.shape
    dft = consts.dft if mma_sync else consts.dft_wgmma
    head = (audio.data_ptr(), int(audio.dtype == torch.int16),
            gain.data_ptr(), batch, n_samples, p.hop_samples,
            n_frames - p.n_features, p.n_features, lay.wpb, lay.n_seg,
            lay.seg_pitch, lay.win_pitch, dft.data_ptr(), lay.k_pad,
            dft.shape[0])
    out_bf16 = int(out.dtype == torch.bfloat16)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        if mma_sync:
            name = "tsc_dft_frontend_bf16"
            fn = _build.bind(name, _DFT_N_ARGS, _DFT_INT_ARGS)
            rc = fn(*head, lay.n_bins, p.n_fft, consts.filt_packed.data_ptr(),
                    consts.filt_packed.numel(), consts.filt_range.data_ptr(),
                    consts.dct_t.data_ptr(), p.n_filt, p.n_mfcc,
                    int(p.use_delta), out.data_ptr(), out_bf16, stream)
        else:
            name = "tsc_dft_frontend_wgmma"
            fn = _build.bind(name, _WGMMA_N_ARGS, _WGMMA_INT_ARGS)
            rc = fn(*head, p.n_fft, consts.bin_key.data_ptr(),
                    consts.bin_w.data_ptr(), consts.slots, int(lay.table_smem),
                    lay.stages, consts.filt_packed.data_ptr(),
                    consts.filt_range.data_ptr(), consts.dct_trim.data_ptr(),
                    p.n_filt, p.n_mfcc, int(p.use_delta), int(lay.logmel),
                    int(lay.shared_sums), consts.filt_home.data_ptr(),
                    consts.tail_filt.data_ptr(), consts.n_bnd,
                    consts.tail_filt.numel(), out.data_ptr(), out_bf16,
                    stream)
    _build.check(rc, name)
    if mma_sync:
        MMA_SYNC.launches += 1
    else:
        dft_frontend_bf16_cuda.launches += 1
        if lay.logmel:
            (DFT_SHARED_SUMS if lay.shared_sums else DFT_LOGMEL).launches += 1


dft_frontend_bf16_cuda.launches = 0
MMA_SYNC = LaunchCount()  # launches of the mma.sync kernel (the A/B)
DFT_LOGMEL = LaunchCount()  # launches of the wgmma kernel in log-mel mode
DFT_SHARED_SUMS = LaunchCount()  # and of log-mel mode's first design


class MfccFrontend:
    """(B, S) audio [, gain] -> (B, n_features, feature_size) features, from
    a snapshot of the config.  CPU tensors take the plain `Frontend` chain.
    CUDA tensors take the route `frontend_route` chose for the config (the
    FFT kernel, route ct's register FFTs, or the plain chain on the card),
    or with fast_math=True the bf16 tensor-core DFT kernel (the counterpart
    of `make_fused_frontend(fast_math=True)`); `.route` names it, on routes
    fft and ct `.body` names the kernel's body (`fft_body`,
    `ct_kernel.ct_body`) and `.cepstrum` whether the cepstrum kernel
    finishes it (`fft_cepstrum`, `ct_kernel.ct_cepstrum`, with fast_math
    `dft_cepstrum`).
    The device is the card unless the caller passes "cpu".  Constructing it
    for a CUDA device raises ValueError when the route's kernels cannot take
    the config, and RuntimeError without CUDA."""

    def __init__(self, params: ListenerParams | None = None,
                 feature_type: str = "mfcc", device=DEFAULT_DEVICE,
                 out_dtype=torch.float32, fast_math: bool = False):
        if out_dtype not in OUT_DTYPES:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
        p = self.params = (params or pr).replace()
        self.out_dtype = out_dtype
        self.fast_math = fast_math
        self.device = torch.device(device)
        self.route = "fast_math" if fast_math else frontend_route(
            p, feature_type)
        self.body = (ct_body(p, feature_type) if self.route == "ct" else
                     fft_body(p, feature_type) if self.route == "fft" else None)
        self.cepstrum = (ct_cepstrum(p, feature_type) if self.route == "ct"
                         and self.body else fft_cepstrum(p, feature_type)
                         if self.route == "fft" else
                         dft_cepstrum(p, feature_type) if fast_math
                         and not dft_config_error(p, feature_type) else False)
        if fast_math:
            err = dft_config_error(p, feature_type)
        elif self.route == "fft":
            err = kernel_config_error(p, feature_type)
        elif self.route == "ct":
            err = ct_config_error(p, feature_type)
        else:
            err = None
        if err and self.device.type == "cuda":
            raise ValueError(err)
        resolve_device(self.device)
        self.plain = Frontend(p, feature_type, self.device,
                              fast_math=fast_math)
        self.consts = None
        if self.device.type == "cuda" and self.route != "torch":
            consts_cls = {"fast_math": DftConstants, "fft": KernelConstants,
                          "ct": CtConstants}[self.route]
            self.consts = consts_cls(p, feature_type, self.device)
            self._unit_gain = torch.ones(1, dtype=torch.float32,
                                         device=self.device)

    @property
    def path(self) -> str:
        """The kernel a CUDA tensor takes, by name: "cuda-mfcc" (the FFT
        kernel's register or radix-2 body), "cuda-mfcc(wide)" (its wide
        body), "cuda-ct" or "cuda-ct(wide)" for route ct's bodies, each with
        "+cep" where the cepstrum kernel finishes it, "torch(xla-route)"
        (the plain chain on the card) or "cuda-fast_math" (with "+cep" in
        its log-mel mode); "torch" (the plain chain) on the CPU."""
        if self.device.type != "cuda":
            return "torch"
        name = {"fft": "cuda-mfcc", "ct": "cuda-ct", "torch": "torch(xla-route)",
                "fast_math": "cuda-fast_math"}[self.route]
        if self.body not in (None, "register", "radix2"):
            name += f"({self.body})"
        return name + "+cep" * self.cepstrum

    def __call__(self, audio: torch.Tensor, gain=None) -> torch.Tensor:
        if audio.device.type == "cpu" or (
                self.route == "torch" and audio.is_cuda
                and self.device.type == "cuda"):
            return self.plain(audio, gain).to(self.out_dtype)
        if not audio.is_cuda or self.consts is None:
            raise ValueError(
                f"frontend built for {self.device} got audio on {audio.device}"
            )
        if gain is None:
            gain_t = self._unit_gain
        else:
            gain_t = torch.as_tensor(gain, dtype=torch.float32,
                                     device=audio.device).reshape(-1)
        if self.route == "ct":
            return ct_frontend_cuda(audio, gain_t, self.consts, self.params,
                                    out_dtype=self.out_dtype)
        launch = dft_frontend_bf16_cuda if self.fast_math else mfcc_frontend_cuda
        return launch(audio, gain_t, self.consts, self.params, self.out_dtype)
