"""The MFCC / bark frontend kernel: wrapper, launch count and plain version.

`csrc/mfcc_frontend.cu` replaces the TPU kernel
`tpu_speech_commands/ops/pallas_frontend.py::_make_ct_frontend` (and takes
the contract of the dense branch of `make_fused_frontend`): gain x audio
(int16 decoded as x/32768), framing, FFT power spectrum, mel or bark
filterbank, log, DCT, log-energy coefficient, optional deltas and the tail
trim to n_features, in one launch.

`MfccFrontend` dispatches on the tensor it is given: a CPU tensor goes
through the plain PyTorch chain (`frontend/dsp.py::Frontend`), a CUDA tensor
launches the kernel or raises.  The kernel needs n_fft a power of two and
window <= n_fft; other configs raise ValueError on CUDA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend.dsp import Frontend
from ..frontend.filterbanks import dct_t_matrix, filterbank_matrix
from ..params import ListenerParams, pr
from . import _build

SOURCE = "tpu_speech_commands_torch/csrc/mfcc_frontend.cu"
REPLACES = "tpu_speech_commands/ops/pallas_frontend.py:745"

# tsc_mfcc_frontend(audio, audio_int16, gain, batch, n_samples, window, hop,
#   n_fft, first_frame, n_features, twiddle, filt_t, dct_t, n_filt, n_mfcc,
#   emit_deltas, out, out_bf16, stream)
_N_ARGS = 19
_INT_ARGS = (1, 3, 4, 5, 6, 7, 8, 9, 13, 14, 15, 17)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def kernel_config_error(p: ListenerParams) -> str | None:
    """Why the kernel cannot take config `p`, or None when it can."""
    n_fft = p.n_fft
    if n_fft < 2 or n_fft & (n_fft - 1):
        return f"the CUDA frontend kernel needs n_fft a power of two, got {n_fft}"
    if p.window_samples > n_fft:
        return (
            "the CUDA frontend kernel needs window_samples <= n_fft, got "
            f"window {p.window_samples} > n_fft {n_fft}"
        )
    if p.n_mfcc > p.n_filt:
        return (
            f"the CUDA frontend kernel needs n_mfcc <= n_filt, got "
            f"{p.n_mfcc} > {p.n_filt}"
        )
    return None


class KernelConstants:
    """Device-resident constants of the kernel for one config: twiddles
    exp(-2 pi i k / n_fft) built in float64 and stored as complex64, the
    filterbank transposed to (n_filt, n_bins), the transposed DCT."""

    def __init__(self, p: ListenerParams, feature_type: str, device):
        k = np.arange(p.n_fft // 2, dtype=np.float64)
        ang = -2.0 * np.pi * k / p.n_fft

        # row-major copies: the matrix functions return transposed views, and
        # torch.tensor keeps a view's column-major strides
        def dev(m):
            return torch.tensor(np.ascontiguousarray(m, dtype=np.float32),
                                device=device)

        self.twiddle = dev(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
        self.filt_t = dev(filterbank_matrix(p, feature_type).T)
        self.dct_t = dev(dct_t_matrix(p.n_filt))
        self.device = self.twiddle.device  # with its index: cuda -> cuda:0
        shapes = ((p.n_fft // 2, 2), (p.n_filt, p.n_fft_bins),
                  (p.n_filt, p.n_filt))
        for t, shape in zip((self.twiddle, self.filt_t, self.dct_t), shapes):
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"kernel constant {tuple(t.shape)} is not a "
                                 f"row-major {shape}")


def mfcc_frontend_cuda(audio: torch.Tensor, gain: torch.Tensor,
                       consts: KernelConstants, p: ListenerParams,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Launch the frontend kernel.  audio (B, S) float32 or int16 and gain
    (1,) float32, both on consts' CUDA device -> (B, n_features,
    feature_size) out_dtype.  Every launch adds one to `.launches`."""
    err = kernel_config_error(p)
    if err:
        raise ValueError(err)
    if not audio.is_cuda or audio.device != consts.device:
        raise ValueError(
            f"audio on {audio.device}, kernel constants on {consts.device}"
        )
    if audio.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"audio must be float32 or int16, got {audio.dtype}")
    if audio.ndim != 2 or not audio.is_contiguous():
        raise ValueError(
            f"audio must be a contiguous (B, S) tensor, got shape "
            f"{tuple(audio.shape)} contiguous={audio.is_contiguous()}"
        )
    if (gain.dtype != torch.float32 or gain.numel() != 1
            or gain.device != audio.device):
        raise ValueError("gain must be one float32 value on the audio's device")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    batch, n_samples = audio.shape
    need = p.window_samples + (p.n_features - 1) * p.hop_samples
    if n_samples < need:
        raise ValueError(
            f"audio length {n_samples} yields fewer than "
            f"n_features={p.n_features} frames (need >= {need} samples)"
        )
    n_frames = 1 + (n_samples - p.window_samples) // p.hop_samples
    n_out = p.feature_size
    out = torch.empty((batch, p.n_features, n_out), dtype=out_dtype,
                      device=audio.device)
    if batch == 0:
        return out
    fn = _build.bind("tsc_mfcc_frontend", _N_ARGS, _INT_ARGS)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = fn(
            audio.data_ptr(), int(audio.dtype == torch.int16),
            gain.data_ptr(), batch, n_samples, p.window_samples,
            p.hop_samples, p.n_fft, n_frames - p.n_features, p.n_features,
            consts.twiddle.data_ptr(), consts.filt_t.data_ptr(),
            consts.dct_t.data_ptr(), p.n_filt, p.n_mfcc, int(p.use_delta),
            out.data_ptr(), int(out_dtype == torch.bfloat16), stream,
        )
    _build.check(rc, "tsc_mfcc_frontend")
    mfcc_frontend_cuda.launches += 1
    return out


mfcc_frontend_cuda.launches = 0


class MfccFrontend:
    """(B, S) audio [, gain] -> (B, n_features, feature_size) features, from
    a snapshot of the config.  CPU tensors take the plain `Frontend` chain;
    CUDA tensors launch the kernel.  Constructing it for a CUDA device
    raises ValueError when the kernel cannot take the config."""

    def __init__(self, params: ListenerParams | None = None,
                 feature_type: str = "mfcc", device="cpu",
                 out_dtype=torch.float32):
        if out_dtype not in _OUT_DTYPES:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
        self.params = (params or pr).replace()
        self.out_dtype = out_dtype
        self.device = torch.device(device)
        err = kernel_config_error(self.params)
        if err and self.device.type == "cuda":
            raise ValueError(err)
        self.plain = Frontend(self.params, feature_type, self.device)
        self.consts = None
        if self.device.type == "cuda":
            self.consts = KernelConstants(self.params, feature_type,
                                          self.device)
            self._unit_gain = torch.ones(1, dtype=torch.float32,
                                         device=self.device)

    def __call__(self, audio: torch.Tensor, gain=None) -> torch.Tensor:
        if audio.device.type == "cpu":
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
        return mfcc_frontend_cuda(audio, gain_t, self.consts, self.params,
                                  self.out_dtype)
