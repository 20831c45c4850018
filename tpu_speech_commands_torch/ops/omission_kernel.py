"""Stage truncations of the frontend kernels: wrappers, launch counts and
the plain version.  The port of the stage-omission profile
`tools/dev/r3_omission.py::_make_truncated` (pallas_call :164), K8's last
site.

The JAX tool cuts the CT frontend kernel after one stage (`STAGES`) and
folds what that stage produced into a fixed (B, 128) float32 output, so no
stage can be dropped and the write costs the same in every cut; successive
rate differences give each stage's cost.  The port cuts two kernels the same
way, each with a compile-time STOP switch:
- the CT split kernel, `csrc/ct_frontend.cu`'s (F, F) instantiation
  (`ct_truncated_cuda`): the port of the TPU kernel;
- the FFT kernel's register body, `csrc/mfcc_frontend.cu`
  (`fft_truncated_cuda`, `FFT_STAGES`: it has no butterfly stage): the
  profile of the port's production frontend.
Every cut but the butterfly is one function of the audio whichever
algorithm computes it, so both kernels are held to one plain version,
`truncated_plain`.  At the one config the JAX tool takes (n_fft 1024 = 8 x
128, hop n_fft / 2, window n_fft), with x the decoded audio times the gain,
frames 0 .. n_frames - 1 and fold(y) the sum over frames of a per-frame row
y, zero-padded or cut to 128 lanes:

  load       x[l] + x[S - 128 + l] (the kernels read every sample)
  framing    fold of sum_a frame[128 a + l] over the 8 planes
  butterfly  fold of T_re[0..4] + T_im[1..3], stage 1 unscaled
  power      fold of P[l] + P[128 + l] + P[256 + l] + P[384 + l] + xnyq: P the
             power row in the CT order (column s 64 + j is bin 8 j + s),
             xnyq the signed Nyquist amplitude sum_n (-1)^n x_n / sqrt(n_fft)
  mel        fold of the filterbank row with its energy column (lane
             n_filt) and the Nyquist bin, zeros above
  log        fold of safe_log of that 128-lane row, the zero lanes too
  full       fold of [log energy, DCT coefficients 1 ..], zeros above

With constant_block, window i reads audio row i mod 16 (`BATCH_TILE`): the
TPU grid reads block 0 at every step.  B must be a multiple of 16, as the
JAX grid leaves any other rows unwritten.  `truncated` dispatches on the
tensor it is given: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..frontend.dsp import decode_audio, frame_signal, safe_log
from ..params import ListenerParams
from . import _build
from ._checks import check_launch
from .ct_constants import LANES
from .ct_kernel import (CtConstants, LaunchCount, ct_nyquist, ct_power,
                        ct_stage1, ct_stage2)
from .frontend_kernel import KernelConstants

STAGES = ("load", "framing", "butterfly", "power", "mel", "log", "full")
FFT_STAGES = tuple(s for s in STAGES if s != "butterfly")
KERNELS = {"ct": STAGES, "fft": FFT_STAGES}
BATCH_TILE = 16
MAX_FRAMES = 64  # the CT kernel's block rows: one window's frames a tile
CT_SOURCE = "tpu_speech_commands_torch/csrc/ct_frontend.cu"
FFT_SOURCE = "tpu_speech_commands_torch/csrc/mfcc_frontend.cu"
REPLACES = "tools/dev/r3_omission.py:164"

# tsc_ct_truncated(audio, audio_int16, gain, batch, n_samples, hop, n_fft,
#   n_frames, stop, src_mod, stage1, e2, filt, filt_nyq, jrange, dct_t,
#   n_filt, n_mfcc, out, stream)
_CT_N_ARGS = 20
_CT_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 16, 17)
# tsc_mfcc_truncated(audio, audio_int16, gain, batch, n_samples, hop, n_fft,
#   n_frames, stop, src_mod, plan_twiddle, filt_packed, fb_table, n_packed,
#   n_seg, dct_t, n_filt, n_mfcc, out, stream)
_FFT_N_ARGS = 20
_FFT_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 13, 14, 16, 17)
_CUDA_ERROR_INVALID_VALUE = 1


def counter_name(kernel: str, stage: str) -> str:
    return f"{kernel}_truncated_{stage}"


# one launch count a (kernel, stage); both block modes count to it
counters = {counter_name(k, s): LaunchCount()
            for k, stages in KERNELS.items() for s in stages}


def truncated_config_error(p: ListenerParams) -> str | None:
    """Why the cuts cannot take config `p`, or None: the config the JAX tool
    asserts (n2 = 8, 2 hop = n_fft) with window = n_fft, and a filterbank
    row that fits 128 lanes."""
    if p.n_fft != 8 * LANES or 2 * p.hop_samples != p.n_fft or \
            p.window_samples != p.n_fft:
        return (f"the stage cuts take the config tools/dev/r3_omission.py "
                f"asserts: n_fft 1024 (n2 = 8), hop n_fft / 2 and window "
                f"n_fft; got n_fft {p.n_fft}, hop {p.hop_samples}, window "
                f"{p.window_samples}")
    if not p.n_mfcc <= p.n_filt < LANES:
        return (f"the stage cuts need n_mfcc <= n_filt < {LANES}, got "
                f"n_mfcc {p.n_mfcc}, n_filt {p.n_filt}")
    if p.max_samples % 4:
        return (f"the load cuts read the audio 4 samples at a time: "
                f"max_samples must be a multiple of 4, got {p.max_samples}")
    return None


def _check(audio: torch.Tensor, p: ListenerParams, stage: str,
           kernel: str = "ct") -> int:
    """Check a cut's arguments on any device; return the frame count."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}: one of {tuple(KERNELS)}")
    if stage not in KERNELS[kernel]:
        raise ValueError(f"unknown stage {stage!r} for the {kernel} kernel: "
                         f"one of {KERNELS[kernel]}")
    err = truncated_config_error(p)
    if err:
        raise ValueError(err)
    if audio.ndim != 2 or audio.shape[1] != p.max_samples:
        raise ValueError(f"audio must be (B, {p.max_samples}), got "
                         f"{tuple(audio.shape)}")
    if audio.shape[0] % BATCH_TILE:
        raise ValueError(f"batch {audio.shape[0]} is not a multiple of "
                         f"{BATCH_TILE}, the JAX tool's batch tile")
    n_frames = 1 + (p.max_samples - p.n_fft) // p.hop_samples
    if n_frames > MAX_FRAMES:
        raise ValueError(f"{n_frames} frames a window: the cuts take at most "
                         f"{MAX_FRAMES}")
    return n_frames


class TruncatedConstants:
    """Device-resident constants of both cut kernels for config `p` (mfcc):
    the CT split's (`.ct`, also the plain version's) and the FFT kernel's
    (`.fft`)."""

    def __init__(self, p: ListenerParams, device):
        err = truncated_config_error(p)
        if err:
            raise ValueError(err)
        self.ct = CtConstants(p, "mfcc", device)
        self.fft = KernelConstants(p, "mfcc", device)
        self.device = self.ct.device


def _fold(y: torch.Tensor) -> torch.Tensor:
    """(B, T, L) per-frame rows -> (B, 128): summed over frames, zero-padded
    or cut to 128 lanes."""
    s = y.sum(1)
    return F.pad(s, (0, max(0, LANES - s.shape[-1])))[:, :LANES]


def truncated_plain(audio: torch.Tensor, gain, p: ListenerParams, stage: str,
                    constant_block: bool = False,
                    consts: CtConstants | None = None) -> torch.Tensor:
    """The cut after `stage` in PyTorch, on the CT constants and the pieces
    of `ct_frontend_plain`: (B, S) float32 or int16 audio [, gain] -> (B,
    128) float32.  consts: the CT constants on the audio's device (built
    when None)."""
    n_frames = _check(audio, p, stage)
    if consts is None:
        consts = CtConstants(p, "mfcc", audio.device)
    x = decode_audio(audio, gain)
    if constant_block:
        x = x[torch.arange(x.shape[0], device=x.device) % BATCH_TILE]
    if stage == "load":
        return x[:, :LANES] + x[:, -LANES:]
    frames = frame_signal(x, p.n_fft, p.hop_samples)[:, :n_frames]
    if stage == "framing":
        return _fold(frames.reshape(*frames.shape[:-1], -1, LANES).sum(2))
    t = ct_stage1(frames, consts)  # (B, T, s <= n2 / 2, [T_re | T_im])
    if stage == "butterfly":
        return _fold(t[..., :LANES].sum(2) + t[..., LANES:].sum(2))
    xs = ct_stage2(t, consts, paired=False)
    power = ct_power(xs * xs)  # (B, T, n_fft / 2), permuted
    xnyq = ct_nyquist(t, p)
    if stage == "power":
        return _fold(power.reshape(*power.shape[:-1], -1, LANES).sum(-2) + xnyq)
    mel_e = torch.matmul(power, consts.filt) + xnyq * xnyq * consts.filt_nyq
    mel_e = F.pad(mel_e, (0, LANES - mel_e.shape[-1]))
    if stage == "mel":
        return _fold(mel_e)
    logs = safe_log(mel_e)
    if stage == "log":
        return _fold(logs)
    coeffs = torch.matmul(logs[..., :p.n_filt], consts.dct_t)
    return _fold(torch.cat([logs[..., p.n_filt:p.n_filt + 1],
                            coeffs[..., 1:p.n_mfcc]], -1))


def _launch(kernel: str, audio: torch.Tensor, gain: torch.Tensor, device,
            p: ListenerParams, stage: str, constant_block: bool, entry: str,
            n_args: int, int_args: tuple, consts_args) -> torch.Tensor:
    """Check, allocate (B, 128), launch `entry`, count the launch."""
    n_frames = _check(audio, p, stage, kernel)
    check_launch(audio, gain, device, p, torch.float32)
    if audio.data_ptr() % (4 * audio.element_size()):
        raise ValueError("the cuts read the audio 4 samples at a time: its "
                         "first sample must be aligned to 4 samples")
    batch, n_samples = audio.shape
    out = torch.empty((batch, LANES), dtype=torch.float32, device=audio.device)
    if batch == 0:
        return out
    fn = _build.bind(entry, n_args, int_args)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = fn(audio.data_ptr(), int(audio.dtype == torch.int16),
                gain.data_ptr(), batch, n_samples, p.hop_samples, p.n_fft,
                n_frames, STAGES.index(stage),
                BATCH_TILE if constant_block else 0, *consts_args,
                p.n_filt, p.n_mfcc, out.data_ptr(), stream)
    if rc == _CUDA_ERROR_INVALID_VALUE and kernel == "ct":
        # every argument was checked above: what is left is shared memory
        raise ValueError("the CUDA CT kernel's cuts need a block of 64 frame "
                         "rows, which fits in no shared memory this card offers")
    _build.check(rc, entry)
    counters[counter_name(kernel, stage)].launches += 1
    return out


def ct_truncated_cuda(audio: torch.Tensor, gain: torch.Tensor,
                      consts: CtConstants, p: ListenerParams, stage: str,
                      constant_block: bool = False) -> torch.Tensor:
    """Launch the CT split kernel cut after `stage`: audio (B, S) float32 or
    int16 and gain (1,) float32 on consts' CUDA device -> (B, 128) float32.
    Every launch adds one to `counters["ct_truncated_<stage>"].launches`."""
    return _launch("ct", audio, gain, consts.device, p, stage, constant_block,
                   "tsc_ct_truncated", _CT_N_ARGS, _CT_INT_ARGS,
                   (consts.stage1.data_ptr(), consts.e2[False].data_ptr(),
                    consts.filt.data_ptr(), consts.filt_nyq.data_ptr(),
                    consts.jrange.data_ptr(), consts.dct_t.data_ptr()))


def fft_truncated_cuda(audio: torch.Tensor, gain: torch.Tensor,
                       consts: KernelConstants, p: ListenerParams, stage: str,
                       constant_block: bool = False) -> torch.Tensor:
    """Launch the FFT kernel cut after `stage` (one of FFT_STAGES): as
    `ct_truncated_cuda`, counting to `counters["fft_truncated_<stage>"]`."""
    return _launch("fft", audio, gain, consts.device, p, stage, constant_block,
                   "tsc_mfcc_truncated", _FFT_N_ARGS, _FFT_INT_ARGS,
                   (consts.plan_twiddle.data_ptr(),
                    consts.filt_packed.data_ptr(), consts.fb_table.data_ptr(),
                    len(consts.fb.packed), consts.fb.n_seg,
                    consts.dct_t.data_ptr()))


def truncated(audio: torch.Tensor, gain, consts: TruncatedConstants,
              p: ListenerParams, stage: str, kernel: str = "ct",
              constant_block: bool = False) -> torch.Tensor:
    """The plain version for a CPU tensor, kernel `kernel`'s cut for a CUDA
    one (gain a float, None or a (1,) tensor; the kernel takes it as a
    device tensor)."""
    _check(audio, p, stage, kernel)
    if audio.device.type == "cpu":
        return truncated_plain(audio, gain, p, stage, constant_block,
                               consts.ct if consts.device.type == "cpu" else None)
    if not isinstance(gain, torch.Tensor):
        gain = torch.full((1,), 1.0 if gain is None else float(gain),
                          dtype=torch.float32, device=audio.device)
    if kernel == "ct":
        return ct_truncated_cuda(audio, gain, consts.ct, p, stage, constant_block)
    return fft_truncated_cuda(audio, gain, consts.fft, p, stage, constant_block)
