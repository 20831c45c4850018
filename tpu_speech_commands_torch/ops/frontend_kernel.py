"""The MFCC / bark frontend kernels: wrappers, launch counts and plain
versions, and the choice of route for a config.

`csrc/mfcc_frontend.cu` replaces the TPU kernel
`tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend` (and takes
the contract of the dense branch of `make_fused_frontend`): gain x audio
(int16 decoded as x/32768), framing, FFT power spectrum, mel or bark
filterbank, log, DCT, log-energy coefficient, optional deltas and the tail
trim to n_features, in one launch.  It has two bodies, chosen from the
config (`fft_body`): the register-resident real-input FFT with the packed
filterbank for n_fft 128 .. 4096 (`fft_plan.py` holds its plan), and the
shared-memory radix-2 FFT for every other power of two.

`csrc/dft_wgmma.cu` replaces the TPU kernel
`tpu_speech_commands/ops/pallas_frontend.py::make_fused_frontend` with
`fast_math=True` (the dense branch, pallas_call :340; and
`tools/dev/pallas_experiments.py::make_bf16_kernel`, the same contract): the
same chain with the DFT as a bf16 GEMM on the tensor cores (wgmma on a
TMA-fed ring, plan `dft_plan.py`), f32 accumulation, and an f32
filterbank, log and DCT.  `csrc/dft_frontend.cu`, its first design
(mma.sync), computes the same function; `_mma_sync=True` runs it for the
A/B.

`MfccFrontend` dispatches on the tensor it is given: a CPU tensor goes
through the plain PyTorch chain (`frontend/dsp.py::Frontend`, with the same
`fast_math`), a CUDA tensor takes the route `frontend_route` chose for the
config when the frontend was built:
- "fft": n_fft a power of two, the FFT kernel (a window longer than n_fft
  is cut to its first n_fft samples, as np.fft.rfft(frame, n=n_fft) does),
  its register body for n_fft 128 .. 4096 and its radix-2 body otherwise;
- "ct": the configs the JAX package's CT kernel takes and the FFT kernel
  cannot, n_fft = 128 n2 (n2 even, not a power of two) == window: the
  mixed-radix register FFT (csrc/mixed_fft_frontend.cu) up to n_fft 4096,
  above it the same register body with a frame over two or four warps
  (csrc/wide_fft_frontend_*.cu), the CT split kernel (csrc/ct_frontend.cu)
  where the register block does not fit and the split's rows do (many
  filters), and above 4096 then the split's (F, T) instantiation, which
  keeps no power row (`ct_kernel.ct_body`: "register", "wide", "split",
  "split-dup"; `MfccFrontend.body` names it);
- "torch": every other config, which the JAX scorer, too, serves with plain
  XLA products outside any Pallas kernel: the plain chain on the card.
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
from ..frontend.filterbanks import dct_t_matrix, dft_matrices, filterbank_matrix
from ..params import ListenerParams, pr
from . import _build
from ._checks import OUT_DTYPES, check_launch, check_row_major, row_major
from .ct_constants import ct_eligible
from .ct_kernel import (CtConstants, LaunchCount, ct_body, ct_config_error,
                        ct_frontend_cuda)
from .dft_plan import (WGMMA_STAGES, column_order, filter_slots,
                       wgmma_rows, wgmma_smem_bytes, wgmma_table_bytes)
from .fft_plan import (SMEM_OPTIN, fft_layout, fft_plan, filterbank_plan,
                       pack_filterbank, takes_register_fft)

SOURCE = "tpu_speech_commands_torch/csrc/mfcc_frontend.cu"
REPLACES = "tpu_speech_commands/ops/pallas_frontend.py:745"
DFT_SOURCE = "tpu_speech_commands_torch/csrc/dft_wgmma.cu"
DFT_MMA_SYNC_SOURCE = "tpu_speech_commands_torch/csrc/dft_frontend.cu"
DFT_REPLACES = "tpu_speech_commands/ops/pallas_frontend.py:340"

# tsc_mfcc_frontend(audio, audio_int16, gain, batch, n_samples, window, hop,
#   n_fft, first_frame, n_features, twiddle, filt_t, dct_t, n_filt, n_mfcc,
#   emit_deltas, out, out_bf16, plan_twiddle, filt_packed, fb_table,
#   n_packed, n_seg, radix2, stream)
_N_ARGS = 25
_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 13, 14, 15, 17, 21, 22, 23)

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
#   filt_range, dct_t, n_filt, n_mfcc, emit_deltas, out, out_bf16, stream)
_WGMMA_N_ARGS = 30
_WGMMA_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 18, 19, 20, 24,
                   25, 26, 28)
# csrc/dft_frontend.cu's tile (the mma.sync kernel): GEMM rows (frames) a
# block, DFT columns a chunk, the K-slice, the B-stage row pitch and the
# B-stage count.  Both kernels take 128 rows a block and the K padded to
# 128 (two of the wgmma kernel's 64-deep slices).
DFT_BM, DFT_BN, DFT_BK, DFT_BKP, DFT_STAGES = 128, 128, 64, 72, 2
# shared memory a block may opt in to on an H100 (227 KB)
DFT_SMEM_MAX = 232448


def frontend_route(p: ListenerParams) -> str:
    """The route `MfccFrontend` takes on CUDA for config `p` (fast_math
    aside): "fft" where n_fft is a power of two, "ct" where the JAX
    package's CT kernel takes the config (`ct_eligible`), else "torch"."""
    n_fft = p.n_fft
    if n_fft >= 2 and not n_fft & (n_fft - 1):
        return "fft"
    return "ct" if ct_eligible(p) else "torch"


def _register_plan(p: ListenerParams, feature_type: str):
    """The register body's plan, filterbank plan and shared-memory layout
    for config `p`."""
    plan = fft_plan(p.n_fft)
    fb = filterbank_plan(filterbank_matrix(p, feature_type).T, plan.lanes)
    return plan, fb, fft_layout(plan, fb, p.n_filt, p.n_mfcc, p.n_features)


def fft_body(p: ListenerParams, feature_type: str = "mfcc") -> str:
    """Which body of the FFT kernel takes config `p` (route "fft"):
    "register" for n_fft 128 .. 4096 where its shared memory fits a block,
    "radix2" for every other power of two (and a config whose filterbank,
    DCT or coefficients leave the register body no room).  Chosen from the
    config, never from a failed launch."""
    if not takes_register_fft(p.n_fft):
        return "radix2"
    smem = _register_plan(p, feature_type)[2].smem_bytes
    return "register" if smem <= SMEM_OPTIN else "radix2"


def kernel_config_error(p: ListenerParams) -> str | None:
    """Why the FFT kernel cannot take config `p`, or None when it can."""
    n_fft = p.n_fft
    if n_fft < 2 or n_fft & (n_fft - 1):
        return f"the CUDA frontend kernel needs n_fft a power of two, got {n_fft}"
    if p.n_mfcc > p.n_filt:
        return (
            f"the CUDA frontend kernel needs n_mfcc <= n_filt, got "
            f"{p.n_mfcc} > {p.n_filt}"
        )
    return None


class KernelConstants:
    """Device-resident constants of the FFT kernel for one config.  Both
    bodies: the transposed DCT.  The radix-2 body: twiddles exp(-2 pi i k /
    n_fft), k < n_fft / 2, built in float64 and stored as float32 (cos, sin)
    rows, and the filterbank transposed to (n_filt, n_bins).  The register
    body, where `fft_body` gives it the config (else None): `plan.twiddle`
    as float32 rows, the packed filterbank and its int32 lane / filter /
    segment table (`fft_plan.filterbank_plan`), and `layout`, its shared
    memory."""

    def __init__(self, p: ListenerParams, feature_type: str, device):
        k = np.arange(p.n_fft // 2, dtype=np.float64)
        ang = -2.0 * np.pi * k / p.n_fft
        filt_t = filterbank_matrix(p, feature_type).T
        self.twiddle = row_major(np.stack([np.cos(ang), np.sin(ang)], axis=-1),
                                 device)
        self.filt_t = row_major(filt_t, device)
        self.dct_t = row_major(dct_t_matrix(p.n_filt), device)
        self.device = self.twiddle.device  # with its index: cuda -> cuda:0
        check_row_major(
            (self.twiddle, self.filt_t, self.dct_t),
            ((p.n_fft // 2, 2), (p.n_filt, p.n_fft_bins), (p.n_filt, p.n_filt)))
        self.plan = self.fb = self.layout = None
        self.plan_twiddle = self.filt_packed = self.fb_table = None
        if fft_body(p, feature_type) == "register":
            self.plan, self.fb, self.layout = _register_plan(p, feature_type)
            self.plan_twiddle = row_major(self.plan.twiddle, device)
            self.filt_packed = row_major(self.fb.packed, device)
            self.fb_table = row_major(self.fb.table, device, np.int32)
            check_row_major((self.plan_twiddle, self.fb_table),
                            ((len(self.plan.twiddle), 2), (len(self.fb.table),)))


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
    else it reads them from the device's copy."""

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
               mma_sync: bool = False) -> DftLayout:
    """The layout of the wgmma kernel, or with mma_sync of the first
    design, at config p: the most windows a block (up to 128 rows) whose
    shared memory fits."""
    n_packed = len(pack_filterbank(filterbank_matrix(p, feature_type).T)[0])
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
    def smem(wpb):
        if mma_sync:
            return _dft_smem_bytes(wpb, win_pitch, p.n_filt, p.n_mfcc, k_pad,
                                   n_packed)
        return wgmma_smem_bytes(wpb, win_pitch, p.n_filt, p.n_mfcc, k_pad)

    while wpb > 1 and smem(wpb) > DFT_SMEM_MAX:
        wpb -= 1
    n_pad = _round_up(2 * p.n_fft_bins, 16)
    nbytes, table, stages = smem(wpb), False, DFT_STAGES
    if not mma_sync:
        stages = max([st for st in WGMMA_STAGES if wgmma_smem_bytes(
            wpb, win_pitch, p.n_filt, p.n_mfcc, k_pad, stages=st)
            <= DFT_SMEM_MAX] or [WGMMA_STAGES[0]])
        nbytes = wgmma_smem_bytes(wpb, win_pitch, p.n_filt, p.n_mfcc, k_pad,
                                  stages=stages)
        rows = wgmma_rows(n_pad)
        slots = filter_slots(filterbank_matrix(p, feature_type).T, rows // 2)
        extra = wgmma_table_bytes(rows, slots.slots)
        table = nbytes + extra <= DFT_SMEM_MAX
        nbytes += extra if table else 0
    return DftLayout(
        k_eff=k_eff, k_pad=k_pad, n_bins=p.n_fft_bins, n_pad=n_pad,
        seg_pitch=seg_pitch, n_seg=n_seg, win_pitch=win_pitch, wpb=wpb,
        smem_bytes=nbytes, table_smem=table, stages=stages,
        wgmma_rows=wgmma_rows(n_pad))


def dft_config_error(p: ListenerParams, feature_type: str = "mfcc",
                     mma_sync: bool = False,
                     layout: DftLayout | None = None) -> str | None:
    """Why the fast_math DFT kernel (the wgmma one, or with mma_sync the
    first design) cannot take config `p`, or None; `layout`, where given,
    is that kernel's `dft_layout` at p (the launch passes its constants'
    layout rather than build it anew).  The wgmma kernel's shared memory at
    one window a block is never more than the first design's, so it takes
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
    smem = (layout or dft_layout(p, feature_type, mma_sync)).smem_bytes
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


class DftConstants:
    """Device-resident constants of the fast_math DFT kernels for one
    config: the bf16 cos|sin matrix (`dft_bf16_matrix`), the transposed
    filterbank packed to its nonzero ranges (`pack_filterbank`) and as the
    wgmma kernel's filter slots over n_pad / 2 bins (`dft_plan.
    filter_slots`: `bin_key`, `bin_w`, `slots`), the transposed DCT; the
    layouts of both kernels (`layout`, `mma_sync_layout`).  The wgmma
    kernel takes the matrix's rows in `dft_plan.column_order`
    (`dft_wgmma`), the mma.sync kernel in the natural order (`dft`)."""

    def __init__(self, p: ListenerParams, feature_type: str, device):
        self.feature_type = feature_type
        self.layout = dft_layout(p, feature_type)
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
        self.dct_t = row_major(dct_t_matrix(p.n_filt), device)
        self.device = self.dft.device
        lay = self.layout
        check_row_major(
            (self.dft, self.dft_wgmma, self.filt_packed, self.filt_range,
             self.bin_key, self.bin_w, self.dct_t),
            ((lay.n_pad, lay.k_pad), (lay.wgmma_rows, lay.k_pad),
             (len(packed),), (p.n_filt, 3),
             (lay.wgmma_rows // 2,), (lay.wgmma_rows // 2, self.slots),
             (p.n_filt, p.n_filt)))


def mfcc_frontend_cuda(audio: torch.Tensor, gain: torch.Tensor,
                       consts: KernelConstants, p: ListenerParams,
                       out_dtype=torch.float32, *,
                       _radix2: bool = False) -> torch.Tensor:
    """Launch the frontend kernel.  audio (B, S) float32 or int16 and gain
    (1,) float32, both on consts' CUDA device -> (B, n_features,
    feature_size) out_dtype.  The body is `fft_body(p)`'s; `_radix2` sends
    a config the register body takes to the radix-2 body instead (the
    same-call A/B of the two).  A launch of the register body adds one to
    `.launches`, one of the radix-2 body to `RADIX2.launches`."""
    err = kernel_config_error(p)
    if err:
        raise ValueError(err)
    n_frames = check_launch(audio, gain, consts.device, p, out_dtype)
    batch, n_samples = audio.shape
    out = torch.empty((batch, p.n_features, p.feature_size), dtype=out_dtype,
                      device=audio.device)
    if batch == 0:
        return out
    radix2 = _radix2 or consts.plan is None
    fn = _build.bind("tsc_mfcc_frontend", _N_ARGS, _INT_ARGS)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        plan_args = (0, 0, 0, 0, 0) if consts.plan is None else (
            consts.plan_twiddle.data_ptr(), consts.filt_packed.data_ptr(),
            consts.fb_table.data_ptr(), len(consts.fb.packed), consts.fb.n_seg)
        rc = fn(
            audio.data_ptr(), int(audio.dtype == torch.int16),
            gain.data_ptr(), batch, n_samples, p.window_samples,
            p.hop_samples, p.n_fft, n_frames - p.n_features, p.n_features,
            consts.twiddle.data_ptr(), consts.filt_t.data_ptr(),
            consts.dct_t.data_ptr(), p.n_filt, p.n_mfcc, int(p.use_delta),
            out.data_ptr(), int(out_dtype == torch.bfloat16), *plan_args,
            int(radix2), stream,
        )
    _build.check(rc, "tsc_mfcc_frontend")
    if radix2:
        RADIX2.launches += 1
    else:
        mfcc_frontend_cuda.launches += 1
    return out


mfcc_frontend_cuda.launches = 0
RADIX2 = LaunchCount()  # launches of the radix-2 body


def dft_frontend_bf16_cuda(audio: torch.Tensor, gain: torch.Tensor,
                           consts: DftConstants, p: ListenerParams,
                           out_dtype=torch.float32, *,
                           _mma_sync: bool = False) -> torch.Tensor:
    """Launch the fast_math (bf16 tensor-core DFT) frontend kernel, the
    wgmma one (csrc/dft_wgmma.cu).  audio (B, S) float32 or int16 and gain
    (1,) float32, both on consts' CUDA device -> (B, n_features,
    feature_size) out_dtype.  `_mma_sync` runs the first design
    (csrc/dft_frontend.cu) instead, the same-call A/B of the two.  A launch
    of the wgmma kernel adds one to `.launches`, one of the mma.sync kernel
    to `MMA_SYNC.launches`."""
    lay = consts.mma_sync_layout if _mma_sync else consts.layout
    err = dft_config_error(p, consts.feature_type, _mma_sync, lay)
    if err:
        raise ValueError(err)
    n_frames = check_launch(audio, gain, consts.device, p, out_dtype)
    batch, n_samples = audio.shape
    out = torch.empty((batch, p.n_features, p.feature_size), dtype=out_dtype,
                      device=audio.device)
    if batch == 0:
        return out
    dft = consts.dft if _mma_sync else consts.dft_wgmma
    head = (audio.data_ptr(), int(audio.dtype == torch.int16),
            gain.data_ptr(), batch, n_samples, p.hop_samples,
            n_frames - p.n_features, p.n_features, lay.wpb, lay.n_seg,
            lay.seg_pitch, lay.win_pitch, dft.data_ptr(), lay.k_pad,
            dft.shape[0])
    tail = (consts.dct_t.data_ptr(), p.n_filt, p.n_mfcc, int(p.use_delta),
            out.data_ptr(), int(out_dtype == torch.bfloat16))
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        if _mma_sync:
            name = "tsc_dft_frontend_bf16"
            fn = _build.bind(name, _DFT_N_ARGS, _DFT_INT_ARGS)
            rc = fn(*head, lay.n_bins, p.n_fft, consts.filt_packed.data_ptr(),
                    consts.filt_packed.numel(), consts.filt_range.data_ptr(),
                    *tail, stream)
        else:
            name = "tsc_dft_frontend_wgmma"
            fn = _build.bind(name, _WGMMA_N_ARGS, _WGMMA_INT_ARGS)
            rc = fn(*head, p.n_fft, consts.bin_key.data_ptr(),
                    consts.bin_w.data_ptr(), consts.slots, int(lay.table_smem),
                    lay.stages,
                    consts.filt_packed.data_ptr(),
                    consts.filt_range.data_ptr(), *tail, stream)
    _build.check(rc, name)
    if _mma_sync:
        MMA_SYNC.launches += 1
    else:
        dft_frontend_bf16_cuda.launches += 1
    return out


dft_frontend_bf16_cuda.launches = 0
MMA_SYNC = LaunchCount()  # launches of the mma.sync kernel (the A/B)


class MfccFrontend:
    """(B, S) audio [, gain] -> (B, n_features, feature_size) features, from
    a snapshot of the config.  CPU tensors take the plain `Frontend` chain.
    CUDA tensors take the route `frontend_route` chose for the config (the
    FFT kernel, the CT kernel's (F, F) instantiation, or the plain chain on
    the card), or with fast_math=True the bf16 tensor-core DFT kernel (the
    counterpart of `make_fused_frontend(fast_math=True)`); `.route` names it,
    and on route ct `.body` names the kernel (`ct_kernel.ct_body`).
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
        self.route = "fast_math" if fast_math else frontend_route(p)
        self.body = ct_body(p, feature_type) if self.route == "ct" else None
        if fast_math:
            err = dft_config_error(p, feature_type)
        elif self.route == "fft":
            err = kernel_config_error(p)
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
        kernel), "cuda-ct" or "cuda-ct(<body>)" for route ct's other
        bodies (wide, split, split-dup), "torch(xla-route)" (the plain
        chain on the card) or
        "cuda-fast_math"; "torch" (the plain chain) on the CPU."""
        if self.device.type != "cuda":
            return "torch"
        name = {"fft": "cuda-mfcc", "ct": "cuda-ct", "torch": "torch(xla-route)",
                "fast_math": "cuda-fast_math"}[self.route]
        if self.body not in (None, "register"):  # route ct's other bodies
            name += f"({self.body})"
        return name

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
