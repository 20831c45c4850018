"""The f32 dense-DFT frontend kernels: wrappers, launch counts and plain
versions.

`csrc/dense_dft_frontend.cu` replaces two TPU kernels of the JAX package's
measurement script `tools/dev/pallas_experiments.py`, which compute one
function, the mfcc chain with a dense f32 DFT, no gain, no deltas and no
trim: (B, S) float32 audio -> (B, n_frames, n_mfcc) float32, n_frames =
1 + (S - window) // hop (the defaults, gain None and first_frame 0):
- `tsc_dense_dft_combined` replaces `make_combined_kernel` (pallas_call
  :76): the frames times cos|sin as one (window, 2 bins) matrix;
- `tsc_dense_dft_halves` replaces `make_reshape_kernel` (pallas_call :188),
  for window == 2 hop: the frames as pairs of adjacent hop blocks and the DFT
  as two half-window products.

Both also take a device gain, applied as g^2 on the power (|g X|^2 = g^2
|X|^2, up to rounding), and a first_frame, the first frame computed: with
the gain and first_frame = n_frames - n_features the combined kernel computes
the f32 contract of the JAX dense frontend, make_fused_frontend(dft_mode=
"dense") (`dev/r4_mxu_stage1.py`'s dense line).

Bound at B 8192 and the default config: 516 GFLOP of f32 DFT on the CUDA
cores, 7.7 ms at 67 TFLOP/s (the FFT kernel, csrc/mfcc_frontend.cu, needs
~30x fewer operations).  `dense_dft_combined` and `dense_dft_halves` dispatch
on the tensor they are given: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.  Both refuse any feature_type but
mfcc (neither JAX kernel takes bark), and halves refuses window != 2 hop,
with ValueError on every device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..frontend.dsp import decode_audio, frame_signal, safe_log
from ..frontend.filterbanks import dct_t_matrix, dft_matrices, filterbank_matrix
from ..params import ListenerParams
from . import _build
from ._checks import check_row_major, row_major
from .frontend_kernel import _round_up, pack_filterbank

SOURCE = "tpu_speech_commands_torch/csrc/dense_dft_frontend.cu"
REPLACES = "tools/dev/pallas_experiments.py:76"
HALVES_REPLACES = "tools/dev/pallas_experiments.py:188"

# tsc_dense_dft_{combined,halves}(audio, gain, first_frame, batch, n_samples,
#   hop, n_frames, rows_per_win, wpb, n_tiles, mat, k_valid, k_pad, n_chunks,
#   n_pairs, nyquist, n_fft, filt_packed, n_packed, filt_range, dct_t, n_filt,
#   n_mfcc, out, stream)
_N_ARGS = 25
_INT_ARGS = (2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 15, 16, 18, 21, 22)
# csrc/dense_dft_frontend.cu's tile: GEMM rows a block, matrix columns a
# chunk, the K-slice
BM, BN, BK = 128, 128, 16


def n_frames_of(p: ListenerParams, n_samples: int) -> int:
    """Frames the JAX kernels cut from n_samples: 1 + (S - window) // hop."""
    return 1 + (n_samples - p.window_samples) // p.hop_samples


def config_error(p: ListenerParams, feature_type: str = "mfcc",
                 halves: bool = False) -> str | None:
    """Why these frontends refuse config `p` on every device, or None."""
    if feature_type != "mfcc":
        return (f"the dense-DFT frontend computes mfcc only (as the JAX "
                f"kernels do), got feature_type {feature_type!r}")
    if halves and p.window_samples != 2 * p.hop_samples:
        return (f"the halves dense-DFT frontend needs window == 2 hop, got "
                f"window {p.window_samples}, hop {p.hop_samples}")
    return None


def smem_bytes(consts: "DenseDftConstants") -> int:
    """Shared memory a block of either CUDA kernel takes for these
    constants, as csrc/dense_dft_frontend.cu computes it (builds the kernel
    library).  A launch past the card's opt-in limit, or with n_mfcc >
    n_filt, fails with the launch's CUDA error."""
    fn = _build.bind("tsc_dense_dft_smem_bytes", 2, (0, 1))
    return fn(consts.params.n_filt, consts.filt_packed.numel())


def column_pairs(p: ListenerParams, rows: int) -> np.ndarray:
    """(rows, 2 n_pairs) float32, n_pairs = (n_fft + 1) // 2: the DFT's
    columns as the kernels take them, in pairs: (cos 0, cos n_fft/2 -- zero
    for an odd n_fft), then (cos p, sin p) for p = 1 .. n_pairs - 1.  The
    Nyquist bin's sin column is zero, so the pairs hold every bin."""
    cos, sin = dft_matrices(p.window_samples, p.n_fft)
    n_pairs = (p.n_fft + 1) // 2
    m = np.zeros((rows, 2 * n_pairs), np.float32)
    used = min(rows, cos.shape[0])
    m[:used, 0::2] = cos[:used, :n_pairs]
    m[:used, 3::2] = sin[:used, 1:n_pairs]
    if p.n_fft % 2 == 0:
        m[:used, 1] = cos[:used, n_pairs]
    return m


@dataclasses.dataclass(frozen=True)
class Tiling:
    """How the kernel cuts (B, n_frames): each block owns wpb windows and
    rows_per_win GEMM rows of each (frames, or hop blocks for halves), and
    n_tiles blocks cover a window's frames."""

    rows_per_win: int
    wpb: int
    n_tiles: int


def tiling(n_frames: int, halves: bool) -> Tiling:
    rows = n_frames + 1 if halves else n_frames  # GEMM rows a window needs
    if rows <= BM:
        return Tiling(rows, BM // rows, 1)
    per_tile = BM - 1 if halves else BM  # frames a tile
    return Tiling(BM, 1, -(-n_frames // per_tile))


def combined_matrix(p: ListenerParams) -> np.ndarray:
    """(k_pad, n_chunks x 128) float32: the column pairs over the first
    min(window, n_fft) samples (the DFT's other rows are zero), rows padded
    to the K-slice and columns to whole chunks with zeros."""
    k_valid = min(p.window_samples, p.n_fft)
    pairs = column_pairs(p, k_valid)
    m = np.zeros((_round_up(k_valid, BK), _round_up(pairs.shape[1], BN)),
                 np.float32)
    m[:k_valid, :pairs.shape[1]] = pairs
    return m


def halves_matrix(p: ListenerParams) -> np.ndarray:
    """(k_pad, n_chunks x 128) float32 for window == 2 hop: chunk c holds
    columns 64 c .. 64 c + 63 of the first hop rows of the column pairs, then
    the same columns of the second hop rows."""
    hop = p.hop_samples
    pairs = column_pairs(p, 2 * hop)
    n_chunks = -(-pairs.shape[1] // (BN // 2))
    halves = np.zeros((2, hop, n_chunks * BN // 2), np.float32)
    halves[:, :, :pairs.shape[1]] = pairs.reshape(2, hop, -1)
    m = np.zeros((_round_up(hop, BK), n_chunks * BN), np.float32)
    m[:hop] = halves.reshape(2, hop, n_chunks, BN // 2).transpose(
        1, 2, 0, 3).reshape(hop, n_chunks * BN)
    return m


class DenseDftConstants:
    """Constants of both frontends for one config, on `device`: the plain
    versions' (window, 2 bins) cos|sin matrix, filterbank and transposed DCT,
    and the kernels' row-major column-pair matrices (`combined_matrix`,
    `halves_matrix` where window == 2 hop), packed filterbank and ranges."""

    def __init__(self, p: ListenerParams, device, feature_type: str = "mfcc"):
        err = config_error(p, feature_type)
        if err:
            raise ValueError(err)
        self.params = p.replace()
        cos, sin = dft_matrices(p.window_samples, p.n_fft)
        self.cos_sin = row_major(np.concatenate([cos, sin], axis=1), device)
        self.filt = row_major(filterbank_matrix(p, "mfcc"), device)
        self.dct_t = row_major(dct_t_matrix(p.n_filt), device)
        self.device = self.cos_sin.device  # with its index: cuda -> cuda:0
        self.combined = row_major(combined_matrix(p), device)
        self.halves = (row_major(halves_matrix(p), device)
                       if p.window_samples == 2 * p.hop_samples else None)
        packed, ranges = pack_filterbank(filterbank_matrix(p, "mfcc").T)
        self.filt_packed = row_major(packed, device)
        self.filt_range = row_major(ranges, device, np.int32)
        self.unit_gain = torch.ones(1, dtype=torch.float32, device=device)
        check_row_major(
            (self.cos_sin, self.filt, self.dct_t, self.filt_packed,
             self.filt_range),
            ((p.window_samples, 2 * p.n_fft_bins), (p.n_fft_bins, p.n_filt),
             (p.n_filt, p.n_filt), (len(packed),), (p.n_filt, 3)))


def _cepstrum(reim: torch.Tensor, consts: DenseDftConstants) -> torch.Tensor:
    """(..., 2 bins) re|im -> (..., n_mfcc): power, mel, log, DCT, and
    coefficient 0 = log energy, as the JAX kernels compute it."""
    p = consts.params
    bins = p.n_fft_bins
    re, im = reim[..., :bins], reim[..., bins:]
    power = (re * re + im * im) * (1.0 / p.n_fft)
    mels = safe_log(torch.matmul(power, consts.filt))
    coeffs = torch.matmul(mels, consts.dct_t)
    energy = safe_log(power.sum(-1, keepdim=True))
    return torch.cat([energy, coeffs[..., 1:p.n_mfcc]], -1)


def _check_audio(audio: torch.Tensor, consts: DenseDftConstants,
                 first_frame: int = 0) -> int:
    """Check the audio and first_frame; return the audio's number of
    frames."""
    if audio.dtype != torch.float32:
        raise TypeError(f"audio must be float32, got {audio.dtype}")
    if audio.ndim != 2:
        raise ValueError(f"audio must be (B, S), got {tuple(audio.shape)}")
    if audio.device != consts.device:
        raise ValueError(f"audio on {audio.device}, constants on {consts.device}")
    n_frames = n_frames_of(consts.params, audio.shape[1])
    if n_frames < 1:
        raise ValueError(f"audio length {audio.shape[1]} is shorter than one "
                         f"window ({consts.params.window_samples} samples)")
    if not 0 <= first_frame < n_frames:
        raise ValueError(f"first_frame {first_frame} outside the audio's "
                         f"{n_frames} frames")
    return n_frames


def dense_dft_combined_plain(audio: torch.Tensor, consts: DenseDftConstants,
                             gain=None, first_frame: int = 0) -> torch.Tensor:
    """(B, S) float32 [, gain] -> (B, n_frames - first_frame, n_mfcc)
    float32: the unfolded frames from first_frame on, times the gain and the
    (window, 2 bins) cos|sin matrix in one matmul, then the cepstrum.
    Float32 throughout (the port pins TF32 off)."""
    _check_audio(audio, consts, first_frame)
    p = consts.params
    frames = frame_signal(decode_audio(audio, gain), p.window_samples,
                          p.hop_samples)[:, first_frame:]
    return _cepstrum(torch.matmul(frames, consts.cos_sin), consts)


def dense_dft_halves_plain(audio: torch.Tensor, consts: DenseDftConstants,
                           gain=None, first_frame: int = 0) -> torch.Tensor:
    """The same function for window == 2 hop: the audio as (B, n_frames + 1,
    hop) blocks, frame t = blocks t and t + 1, and the DFT as two half-window
    matmuls, blocks[:-1] @ M[:hop] + blocks[1:] @ M[hop:]."""
    n_frames = _check_audio(audio, consts, first_frame) - first_frame
    p = consts.params
    err = config_error(p, halves=True)
    if err:
        raise ValueError(err)
    hop = p.hop_samples
    audio = decode_audio(audio, gain)[:, first_frame * hop:]
    blocks = audio[:, :(n_frames + 1) * hop].reshape(audio.shape[0], -1, hop)
    reim = (torch.matmul(blocks[:, :-1], consts.cos_sin[:hop])
            + torch.matmul(blocks[:, 1:], consts.cos_sin[hop:]))
    return _cepstrum(reim, consts)


def _launch(name, halves, audio, consts, gain, first_frame) -> torch.Tensor:
    p = consts.params
    err = config_error(p, halves=halves)
    if err:
        raise ValueError(err)
    n_frames = _check_audio(audio, consts, first_frame) - first_frame
    if not audio.is_cuda:
        raise ValueError(f"audio must be a CUDA tensor, got {audio.device}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    if gain is None:
        gain = consts.unit_gain
    elif (not isinstance(gain, torch.Tensor) or gain.dtype != torch.float32
          or gain.numel() != 1 or gain.device != audio.device):
        raise ValueError("gain must be one float32 value on the audio's device")
    batch, n_samples = audio.shape
    out = torch.empty((batch, n_frames, p.n_mfcc), dtype=torch.float32,
                      device=audio.device)
    if batch == 0:
        return out
    mat = consts.halves if halves else consts.combined
    tile = tiling(n_frames, halves)
    k_valid = p.hop_samples if halves else min(p.window_samples, p.n_fft)
    fn = _build.bind(name, _N_ARGS, _INT_ARGS)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = fn(
            audio.data_ptr(), gain.data_ptr(), first_frame, batch, n_samples,
            p.hop_samples, n_frames,
            tile.rows_per_win, tile.wpb, tile.n_tiles, mat.data_ptr(), k_valid,
            mat.shape[0], mat.shape[1] // BN, (p.n_fft + 1) // 2,
            int(p.n_fft % 2 == 0), p.n_fft, consts.filt_packed.data_ptr(),
            consts.filt_packed.numel(), consts.filt_range.data_ptr(),
            consts.dct_t.data_ptr(), p.n_filt, p.n_mfcc, out.data_ptr(),
            stream,
        )
    _build.check(rc, name)
    return out


def dense_dft_combined_cuda(audio: torch.Tensor, consts: DenseDftConstants,
                            gain: torch.Tensor | None = None,
                            first_frame: int = 0) -> torch.Tensor:
    """Launch the combined kernel: (B, S) float32 audio and an optional (1,)
    float32 gain on consts' CUDA device -> (B, n_frames - first_frame,
    n_mfcc) float32.  Every launch adds one to `.launches`."""
    out = _launch("tsc_dense_dft_combined", False, audio, consts, gain,
                  first_frame)
    if out.shape[0]:
        dense_dft_combined_cuda.launches += 1
    return out


dense_dft_combined_cuda.launches = 0


def dense_dft_halves_cuda(audio: torch.Tensor, consts: DenseDftConstants,
                          gain: torch.Tensor | None = None,
                          first_frame: int = 0) -> torch.Tensor:
    """Launch the halves kernel (window == 2 hop), the same contract as
    `dense_dft_combined_cuda`.  Every launch adds one to `.launches`."""
    out = _launch("tsc_dense_dft_halves", True, audio, consts, gain,
                  first_frame)
    if out.shape[0]:
        dense_dft_halves_cuda.launches += 1
    return out


dense_dft_halves_cuda.launches = 0


def dense_dft_combined(audio: torch.Tensor, consts: DenseDftConstants,
                       gain=None, first_frame: int = 0) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if audio.device.type == "cpu":
        return dense_dft_combined_plain(audio, consts, gain, first_frame)
    return dense_dft_combined_cuda(audio, consts, gain, first_frame)


def dense_dft_halves(audio: torch.Tensor, consts: DenseDftConstants,
                     gain=None, first_frame: int = 0) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if audio.device.type == "cpu":
        return dense_dft_halves_plain(audio, consts, gain, first_frame)
    return dense_dft_halves_cuda(audio, consts, gain, first_frame)
