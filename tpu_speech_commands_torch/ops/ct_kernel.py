"""The Cooley-Tukey (CT) split frontend kernel: wrapper, launch counts and
plain version.

`csrc/ct_frontend.cu` computes what the JAX package's CT kernel computes
(`tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend`,
pallas_call :745, and its variants in `tools/dev/`, the K8 kernels), with the
scorer's whole contract: f32 or int16 audio times a device gain, the CT split
DFT (`ct_constants.py`), the permuted mel or bark filterbank with its energy
column, log, DCT, optional deltas, the tail trim to n_features, f32 or bf16
out, batch-major (B, T, F) or time-major (T, B, F).

Two compile-time switches carry over from the TPU variants, four
instantiations (`VARIANTS`):
- paired: the conjugate residues s and n2 - s share one read of the T rows,
  one product of 256 columns (`r3_stage2.py`'s paired);
- per_piece_mel: the filterbank runs on each residue's unfolded squares
  against duplicated rows, with no power row in shared memory
  (`r3_frontend_variants.py`'s mel='dup', `r3_stage2.py`'s ppmel).
The TPU variants that differ only in how vregs and lanes are laid out
(framing concat / reshape, wide cells, batch_tile) compute the same function
the same way here, and map onto these four.

`MfccFrontend` takes route "ct" for the configs the JAX scorer runs through
its CT kernel and the FFT kernel cannot take.  Route ct's function, the
(F, F) contract, has two bodies, chosen from the config (`ct_body`):
- "register", `csrc/mixed_fft_frontend.cu`: a mixed-radix register-resident
  real-input FFT (the plan `fft_plan.mixed_plan`) for every n_fft up to
  4096;
- "wide", `csrc/wide_fft_frontend_*.cu` (`csrc/wide_fft.cuh`): the same
  register body with a frame over two or four warps (`fft_plan.wide_plan`)
  for every n_fft above 4096 (4352 .. 15872 at a 1 s buffer, 8192 aside,
  which route fft takes).
Each keeps only the DCT columns the output uses; where even those leave
the block too little room (many filters and coefficients:
`fft_plan.cepstrum_mode`, `ct_cepstrum`), the body runs in log-mel mode and
the cepstrum kernel (`csrc/cepstrum_wgmma.cu`,
`frontend_kernel.cepstrum_cuda`) finishes.  The CT split kernel's instantiations are the A/B baselines:
(F, F) through `_split=True` (the `dev/` variants measure the split this
way), its (F, T) instantiation ("split-dup", `ct_frontend_dup`, the
per-piece mel, which keeps no power row) through `per_piece_mel=True`.  A
config neither body takes, even in log-mel mode, raises ValueError from the
config, before any launch (`ct_config_error`).
`ct_frontend` dispatches on the tensor it is given: a
CPU tensor takes `ct_frontend_plain`, a CUDA tensor launches a kernel or
raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend.dsp import add_deltas, decode_audio, frame_signal, safe_log
from ..frontend.filterbanks import filterbank_matrix
from ..params import ListenerParams
from . import _build
from ._checks import OUT_DTYPES, check_launch, check_row_major, row_major
from .cepstrum_plan import (LOGMEL_PARTIAL, LOGMEL_ROWS, DctTables,
                            logmel_buffer, register_layout)
from .ct_constants import CT_J, LANES, ct_eligible, ct_matrices
from .fft_plan import (SMEM_OPTIN, cepstrum_mode, fft_layout, filterbank_plan,
                       mixed_plan, takes_mixed_fft, takes_wide_fft, wide_plan,
                       wide_unit)
from .launch_count import LOGMEL, PARTIAL_SUMS, LaunchCount

SOURCE = "tpu_speech_commands_torch/csrc/ct_frontend.cu"
MIXED_SOURCE = "tpu_speech_commands_torch/csrc/mixed_fft_frontend.cu"
WIDE_SOURCE = "tpu_speech_commands_torch/csrc/wide_fft.cuh"
_K1 = "tpu_speech_commands/ops/pallas_frontend.py:745"
_VARIANTS_PY = "tools/dev/r3_frontend_variants.py:171"
_STAGE2 = "tools/dev/r3_stage2.py:182"
_WIDECELL = "tools/dev/r3_widecell.py:169"

# name: (paired, per_piece_mel, the pallas_calls it counts for).  (F, F):
# K1 for route "ct", r3_frontend_variants' mel concat (both framings),
# r3_stage2's perres, r3_widecell; (T, F): r3_stage2's paired; (T, T):
# r3_stage2's ppmel; (F, T): r3_frontend_variants' mel dup (both framings)
VARIANTS = {
    "ct_frontend": (False, False, f"{_K1}, {_VARIANTS_PY}, {_STAGE2}, "
                    f"{_WIDECELL}"),
    "ct_frontend_paired": (True, False, _STAGE2),
    "ct_frontend_ppmel": (True, True, _STAGE2),
    "ct_frontend_dup": (False, True, _VARIANTS_PY),
}

# tsc_ct_frontend(audio, audio_int16, gain, batch, n_samples, hop, n_fft,
#   first_frame, n_features, paired, per_piece_mel, stage1, e2, filt,
#   filt_nyq, jrange, dct_t, n_filt, n_mfcc, emit_deltas, time_major, out,
#   out_bf16, stream).  The kernel picks its block rows and tiling itself.
_N_ARGS = 24
_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 10, 17, 18, 19, 20, 22)
# tsc_mixed_fft_frontend and tsc_wide_fft_frontend_<u>(audio, audio_int16,
#   gain, batch, n_samples, hop, n_fft, first_frame, n_features,
#   plan_twiddle, filt_packed, fb_table, n_packed, n_seg, dct_t, dct_cols,
#   n_filt, n_mfcc, emit_deltas, time_major, n_warps, out, out_bf16,
#   logmel, stream)
_REGISTER_N_ARGS = 25
_REGISTER_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 12, 13, 15, 16, 17, 18, 19, 20,
                      22, 23)
_CUDA_ERROR_INVALID_VALUE = 1
# csrc/ct_frontend.cu's kStages, kBK and kBms: the K-slice ring's stages and
# depth, and the block rows it tries, largest first
# (tests/test_torch_ct_frontend.py holds them to the source)
_SPLIT_STAGES, _SPLIT_BK, _SPLIT_BMS = 3, 8, (64, 32)


counters = {name: LaunchCount() for name in VARIANTS}
MIXED = LaunchCount()  # launches of the mixed-radix register FFT
WIDE = LaunchCount()  # launches of the wide register FFT (above 4096)


def variant_name(paired: bool, per_piece_mel: bool) -> str:
    return next(name for name, (pa, pp, _) in VARIANTS.items()
                if (pa, pp) == (bool(paired), bool(per_piece_mel)))


def split_smem_bytes(bm: int, n_fft: int, n_filt: int, n_mfcc: int,
                     per_piece_mel: bool = False) -> int:
    """The CT split's unpaired instantiation's shared memory for a block of
    bm frame rows, (F, F) or with per_piece_mel (F, T):
    smem_floats(bm, n_fft, n_filt, n_mfcc, false, per_piece_mel) of
    csrc/ct_frontend.cu, in bytes.  (F, T) keeps one residue's squares
    (pitch 129) where (F, F) keeps the power rows (n_fft / 2 + 1).  The
    bm x n_mfcc coefficients take the idle T, ring and power space after
    the last residue, or a region of their own where they outnumber it
    (coef_floats)."""
    sq = LANES + 1 if per_piece_mel else n_fft // 2 + 1
    room = 2 * LANES * (bm + 4) + _SPLIT_STAGES * _SPLIT_BK * LANES + bm * sq
    coef = 0 if bm * n_mfcc <= room else bm * n_mfcc
    return 4 * (2 * bm + room + bm * ((n_filt + 1) | 1) + bm + coef)


def split_rows(p: ListenerParams, per_piece_mel: bool = False) -> int:
    """The frame rows a block of tsc_ct_frontend's unpaired (F, F)
    instantiation, or with per_piece_mel its (F, T) one, takes at config p:
    the first of 64 and 32 whose block fits SMEM_OPTIN, or 0 where neither
    does and the launch refuses."""
    return next((bm for bm in _SPLIT_BMS
                 if split_smem_bytes(bm, p.n_fft, p.n_filt, p.n_mfcc,
                                     per_piece_mel) <= SMEM_OPTIN), 0)


def split_fits(p: ListenerParams, per_piece_mel: bool = False) -> bool:
    """Whether tsc_ct_frontend launches that instantiation at config p."""
    return split_rows(p, per_piece_mel) > 0


def _register(p: ListenerParams, feature_type: str):
    """The mixed-radix or wide plan and its filterbank plan for config
    `p`."""
    plan = mixed_plan(p.n_fft) if takes_mixed_fft(p.n_fft) else \
        wide_plan(p.n_fft)
    return plan, filterbank_plan(filterbank_matrix(p, feature_type).T,
                                 plan.lanes)


def ct_body(p: ListenerParams, feature_type: str = "mfcc") -> str | None:
    """Which kernel serves route ct's config `p` on CUDA: "register" (the
    mixed-radix FFT) or "wide" (the wide FFT) where one has a plan whose
    block fits SMEM_OPTIN, fused or in log-mel mode (`ct_cepstrum`); None
    where neither does.  Chosen from the config, never from a failed
    launch."""
    for body, takes in (("register", takes_mixed_fft),
                        ("wide", takes_wide_fft)):
        if takes(p.n_fft) and fft_layout(
                *_register(p, feature_type), p.n_filt, p.n_mfcc,
                p.n_features, cepstrum=True).smem_bytes <= SMEM_OPTIN:
            return body
    return None


def ct_cepstrum(p: ListenerParams, feature_type: str = "mfcc") -> bool:
    """Whether route ct's body runs config `p` in log-mel mode with the
    cepstrum kernel after it (`fft_plan.cepstrum_mode`)."""
    return ct_body(p, feature_type) is not None and cepstrum_mode(
        *_register(p, feature_type), p.n_filt, p.n_mfcc, p.n_features)


def _contract_error(p: ListenerParams) -> str | None:
    """Why config `p` is outside route ct's contract, or None."""
    if not ct_eligible(p):
        return (f"the CUDA CT frontend kernel needs n_fft = 128 n2 with n2 "
                f"even and window == n_fft, got n_fft {p.n_fft}, window "
                f"{p.window_samples}")
    if p.n_mfcc > p.n_filt:
        return (f"the CUDA CT frontend kernel needs n_mfcc <= n_filt, got "
                f"{p.n_mfcc} > {p.n_filt}")
    return None


def ct_config_error(p: ListenerParams,
                    feature_type: str = "mfcc") -> str | None:
    """Why route ct's kernels cannot take config `p`, or None when one can."""
    err = _contract_error(p)
    if err:
        return err
    if ct_body(p, feature_type) is None:
        why = (f"its block does not fit in {SMEM_OPTIN} bytes of shared "
               f"memory even in log-mel mode" if takes_mixed_fft(p.n_fft)
               or takes_wide_fft(p.n_fft) else "it has no plan for this n_fft")
        return (f"no CUDA kernel of route ct takes n_fft {p.n_fft} with "
                f"{p.n_filt} filters and {p.n_mfcc} coefficients: not the "
                f"register FFT ({why})")
    return None


class CtConstants(DctTables):
    """Device-resident constants of route ct's kernels and the plain version
    for one config.  The CT split's (`ct_constants.ct_matrices`): the stage-1
    tables, the unpaired and paired stage-2 packs, the permuted filterbank,
    its per-piece ranges and duplicated-row form and the Nyquist row; the
    DCT tables (`DctTables`).  `body` is `ct_body`'s; where it is
    "register" or "wide", the register FFT's too (`DctTables.
    stage_register`: the twiddles, the fused filterbank plan's and log-mel
    mode's step tables over the plan's lanes, `cepstrum` and `layout`)."""

    def __init__(self, p: ListenerParams, feature_type: str, device):
        if not ct_eligible(p):
            raise ValueError(ct_config_error(p))
        super().__init__(p, device)
        m = ct_matrices(p.n_fft, p.n_filt, p.sample_rate, feature_type)
        self.n2 = m.n2
        self.stage1 = row_major(m.stage1, device)
        self.e2 = {paired: row_major(m.stage2_pack(paired), device)
                   for paired in (False, True)}
        self.filt = row_major(m.filt_half, device)
        self.filt_dup = row_major(m.filt_dup(), device)
        self.filt_nyq = row_major(m.filt_nyq, device)
        self.jrange = row_major(m.piece_ranges(), device, np.int32)
        self.device = self.stage1.device  # with its index: cuda -> cuda:0
        n2, half, nf1 = m.n2, m.half, p.n_filt + 1
        check_row_major(
            (self.stage1, self.e2[False], self.e2[True], self.filt,
             self.filt_dup, self.filt_nyq, self.jrange, self.dct_t),
            ((2, n2, n2), (n2, 2 * LANES, LANES),
             (half + 1, 2 * LANES, 2 * LANES), (n2 * CT_J, nf1),
             (n2, LANES, nf1), (nf1,), (nf1, n2, 2), (p.n_filt, p.n_filt)))
        self.feature_type = feature_type
        self.body = ct_body(p, feature_type)
        self.plan = self.fb = self.layout = None
        self.plan_twiddle = self.filt_packed = self.fb_table = None
        self.cepstrum = False
        if self.body is not None:
            self.stage_register(*_register(p, feature_type), p, device)


def ct_frontend_plain(audio: torch.Tensor, gain, consts: CtConstants,
                      p: ListenerParams, paired: bool = False,
                      per_piece_mel: bool = False, time_major: bool = False,
                      out_dtype=torch.float32) -> torch.Tensor:
    """The CT split in PyTorch: unfold the kept frames, stage 1 as an einsum
    against the stage-1 tables, stage 2 against the unpaired or paired packs,
    the fold and permuted filterbank or the per-piece filterbank on the
    unfolded squares, then log, DCT, energy, deltas.  (B, S) float32 or
    int16 audio [, gain] -> (B, n_features, F), or (n_features, B, F) when
    time_major, in out_dtype (computed in float32)."""
    x = decode_audio(audio, gain)
    n_frames = 1 + (x.shape[-1] - p.window_samples) // p.hop_samples
    if n_frames < p.n_features:
        raise ValueError(f"audio length {x.shape[-1]} yields fewer than "
                         f"n_features={p.n_features} frames")
    frames = frame_signal(x, p.n_fft, p.hop_samples)
    frames = frames[:, n_frames - p.n_features:n_frames]
    t = ct_stage1(frames, consts)
    xs = ct_stage2(t, consts, paired)
    xnyq = ct_nyquist(t, p)
    sq = xs * xs
    if per_piece_mel:
        mel_e = torch.einsum("ntsc,scm->ntm", sq, consts.filt_dup)
    else:
        mel_e = torch.matmul(ct_power(sq), consts.filt)
    logs = safe_log(mel_e + xnyq * xnyq * consts.filt_nyq)
    coeffs = torch.matmul(logs[..., :p.n_filt], consts.dct_t)
    out = torch.cat([logs[..., p.n_filt:], coeffs[..., 1:p.n_mfcc]], -1)
    if p.use_delta:
        out = add_deltas(out)
    if time_major:
        out = out.transpose(0, 1).contiguous()
    return out.to(out_dtype)


def ct_stage1(frames: torch.Tensor, consts: CtConstants) -> torch.Tensor:
    """(B, T, n_fft) frames -> (B, T, n2 / 2 + 1, 256): stage 1 for the
    residues s <= n2 / 2 against the stage-1 tables, [T_re | T_im] over b."""
    planes = frames.reshape(*frames.shape[:-1], consts.n2, LANES)  # (B, T, a, b)
    tab = consts.stage1[:, :consts.n2 // 2 + 1]
    return torch.cat([torch.einsum("ntak,sa->ntsk", planes, tab[0]),
                      torch.einsum("ntak,sa->ntsk", planes, tab[1])], -1)


def ct_stage2(t: torch.Tensor, consts: CtConstants, paired: bool) -> torch.Tensor:
    """Stage 2 against the unpaired or paired packs: (B, T, n2, [Xr | Xi])
    of the bins n2 j + s, scaled by 1 / sqrt(n_fft)."""
    n2, half = consts.n2, consts.n2 // 2
    if paired:
        groups = torch.einsum("ntsk,skc->ntsc", t, consts.e2[True])
        xs = [None] * n2
        for s in range(half + 1):
            xs[s] = groups[:, :, s, :LANES]
            if s not in (0, half):
                xs[n2 - s] = groups[:, :, s, LANES:]
        return torch.stack(xs, 2)
    sr = [s if s <= half else n2 - s for s in range(n2)]
    return torch.einsum("ntsk,skc->ntsc", t[:, :, sr], consts.e2[False])


def ct_power(sq: torch.Tensor) -> torch.Tensor:
    """(B, T, n2, 128) squares -> (B, T, n_fft / 2) power row, permuted:
    column s * 64 + j holds bin n2 j + s."""
    return (sq[..., :CT_J] + sq[..., CT_J:]).flatten(2)


def ct_nyquist(t: torch.Tensor, p: ListenerParams) -> torch.Tensor:
    """(B, T, 1): the Nyquist bin's signed amplitude, sum_b (-1)^b T[0, b] /
    sqrt(n_fft)."""
    sign = 1.0 - 2.0 * (torch.arange(LANES, device=t.device) % 2)
    alt = sign.to(torch.float32) * float(1.0 / np.sqrt(p.n_fft))
    return (t[:, :, 0, :LANES] * alt).sum(-1, keepdim=True)


def ct_frontend_cuda(audio: torch.Tensor, gain: torch.Tensor,
                     consts: CtConstants, p: ListenerParams,
                     paired: bool = False, per_piece_mel: bool = False,
                     time_major: bool = False,
                     out_dtype=torch.float32, *,
                     _split: bool = False, _full_dct: bool = False,
                     _cepstrum: bool | None = None,
                     _partial_sums: bool = False) -> torch.Tensor:
    """Launch route ct's kernel for config `p`.  audio (B, S) float32 or
    int16 and gain (1,) float32, both on consts' CUDA device -> (B,
    n_features, F), or (n_features, B, F) when time_major, in out_dtype.

    The (F, F) contract runs `consts.body`'s kernel, the mixed-radix FFT
    (its launches add one to `MIXED.launches`) or the wide FFT (to
    `WIDE.launches`), fused or, where `consts.cepstrum`, in log-mel mode
    with the cepstrum kernel after it (`frontend_kernel.cepstrum_cuda`,
    counted in `frontend_kernel.CEPSTRUM`; the log-mel rows by
    `ct_logmel_cuda`).  The same-call A/Bs: `_full_dct` runs the fused
    epilogue on the whole n_filt x n_filt DCT, `_cepstrum` (True or False)
    forces the mode, `_partial_sums` runs log-mel mode's first tail;
    paired or per_piece_mel
    (split-dup, the wide FFT's baseline), or `_split` (the mixed FFT's),
    launch that instantiation of the CT split kernel, each launch adding
    one to `counters[variant_name(paired, per_piece_mel)].launches`."""
    split = _split or paired or per_piece_mel
    err = _contract_error(p)
    if not err and consts.body is None and not split:
        err = ct_config_error(p, consts.feature_type)
    if err:
        raise ValueError(err)
    cepstrum = not split and (consts.cepstrum if _cepstrum is None
                              else _cepstrum)
    if cepstrum:
        # frontend_kernel imports this module: its cepstrum wrapper is
        # looked up at the call
        from .frontend_kernel import cepstrum_cuda

        check_launch(audio, gain, consts.device, p, out_dtype)
        rows = ct_logmel_cuda(audio, gain, consts, p,
                              _partial_sums=_partial_sums)
        return cepstrum_cuda(rows, consts.cep_table, p.n_mfcc, p.use_delta,
                             time_major, out_dtype)
    lay = None if split else register_layout(consts, p, _full_dct, False)
    n_frames = check_launch(audio, gain, consts.device, p, out_dtype)
    batch, n_samples = audio.shape
    shape = ((p.n_features, batch, p.feature_size) if time_major
             else (batch, p.n_features, p.feature_size))
    if batch == 0:
        return torch.empty(shape, dtype=out_dtype, device=audio.device)
    first_frame = n_frames - p.n_features
    if not split:
        out = torch.empty(shape, dtype=out_dtype, device=audio.device)
        _launch_register(audio, gain, consts, p, first_frame, time_major,
                         out, lay.warps, _full_dct, 0)
        (MIXED if consts.body == "register" else WIDE).launches += 1
        return out
    out = torch.empty(shape, dtype=out_dtype, device=audio.device)
    fn = _build.bind("tsc_ct_frontend", _N_ARGS, _INT_ARGS)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = fn(
            audio.data_ptr(), int(audio.dtype == torch.int16), gain.data_ptr(),
            batch, n_samples, p.hop_samples, p.n_fft, first_frame,
            p.n_features, int(paired), int(per_piece_mel),
            consts.stage1.data_ptr(), consts.e2[bool(paired)].data_ptr(),
            consts.filt.data_ptr(), consts.filt_nyq.data_ptr(),
            consts.jrange.data_ptr(), consts.dct_t.data_ptr(), p.n_filt,
            p.n_mfcc, int(p.use_delta), int(time_major), out.data_ptr(),
            int(out_dtype == torch.bfloat16), stream,
        )
    if rc == _CUDA_ERROR_INVALID_VALUE:
        # every argument was checked above: what is left is shared memory
        raise ValueError(
            f"the CUDA CT frontend kernel ({variant_name(paired, per_piece_mel)})"
            f" cannot take n_fft {p.n_fft} with {p.n_filt} filters: a block "
            f"of its frame rows fits in no shared memory this card offers")
    _build.check(rc, "tsc_ct_frontend")
    counters[variant_name(paired, per_piece_mel)].launches += 1
    return out


def ct_logmel_cuda(audio: torch.Tensor, gain: torch.Tensor,
                   consts: CtConstants, p: ListenerParams, *,
                   _partial_sums: bool = False) -> torch.Tensor:
    """Launch route ct's register or wide body in log-mel mode: audio (B, S)
    float32 or int16 and gain (1,) float32 on consts' CUDA device -> the (B,
    n_features, n_filt + 1) f32 log-mel rows, the log energy last (the
    plain version: `cepstrum_plan.logmel_plain`).  `_partial_sums` runs the
    mode's first tail, the same-call A/B.  A launch adds one to its body's
    count (`MIXED` or `WIDE`) and to `LOGMEL` (`PARTIAL_SUMS`)."""
    err = _contract_error(p)
    if not err and consts.body is None:
        err = ct_config_error(p, consts.feature_type)
    if err:
        raise ValueError(err)
    lay = register_layout(consts, p, False, True, _partial_sums)
    n_frames = check_launch(audio, gain, consts.device, p, torch.float32)
    out = logmel_buffer(audio, p)
    if audio.shape[0] == 0:
        return out
    _launch_register(audio, gain, consts, p, n_frames - p.n_features, False,
                     out, lay.warps, False,
                     LOGMEL_PARTIAL if _partial_sums else LOGMEL_ROWS)
    (MIXED if consts.body == "register" else WIDE).launches += 1
    (PARTIAL_SUMS if _partial_sums else LOGMEL).launches += 1
    return out


def _launch_register(audio, gain, consts: CtConstants, p: ListenerParams,
                     first_frame: int, time_major: bool, out: torch.Tensor,
                     warps: int, full_dct: bool, logmel: int):
    """One launch of csrc/mixed_fft_frontend.cu or, for the wide body, of
    n_fft's unit of csrc/wide_fft_frontend_*.cu into `out` (with logmel,
    LOGMEL_ROWS or LOGMEL_PARTIAL, the (B, n_features, n_filt + 1) log-mel
    rows)."""
    name = ("tsc_mixed_fft_frontend" if consts.body == "register" else
            f"tsc_wide_fft_frontend_{wide_unit(p.n_fft)}")
    fn = _build.bind(name, _REGISTER_N_ARGS, _REGISTER_INT_ARGS)
    dct_ptr, dct_cols = consts.dct_args(p, full_dct)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = fn(
            audio.data_ptr(), int(audio.dtype == torch.int16), gain.data_ptr(),
            audio.shape[0], audio.shape[1], p.hop_samples, p.n_fft,
            first_frame, p.n_features, consts.plan_twiddle.data_ptr(),
            *consts.fb_args(logmel == LOGMEL_ROWS), dct_ptr, dct_cols,
            p.n_filt, p.n_mfcc, int(p.use_delta),
            int(time_major and not logmel), warps, out.data_ptr(),
            int(out.dtype == torch.bfloat16), logmel, stream,
        )
    _build.check(rc, name)


def ct_frontend(audio: torch.Tensor, gain, consts: CtConstants,
                p: ListenerParams, paired: bool = False,
                per_piece_mel: bool = False, time_major: bool = False,
                out_dtype=torch.float32, *,
                _split: bool = False) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one (gain
    a float, None or a (1,) tensor; the kernel takes it as a device
    tensor)."""
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if audio.device.type == "cpu":
        return ct_frontend_plain(audio, gain, consts, p, paired, per_piece_mel,
                                 time_major, out_dtype)
    if not isinstance(gain, torch.Tensor):
        gain = torch.full((1,), 1.0 if gain is None else float(gain),
                          dtype=torch.float32, device=audio.device)
    return ct_frontend_cuda(audio, gain, consts, p, paired, per_piece_mel,
                            time_major, out_dtype, _split=_split)
