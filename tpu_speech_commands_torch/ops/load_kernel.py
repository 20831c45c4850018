"""The audio-read floor kernels: wrappers, launch counts and plain versions.

`csrc/audio_load.cu` replaces two TPU kernels of the JAX package's
measurement scripts, which read the audio once and write almost nothing, to
measure the bandwidth bound of every frontend:
- `tsc_load_rowsum` replaces `tools/dev/r3_experiments.py::make_load_only`:
  (B, S) float32 audio and a gain -> (B, 1) float32 sum(audio * gain, 1);
- `tsc_load_broadcast` replaces the `load_kernel` closure of
  `tools/dev/r4_mxu_stage1.py::main`: the same row sum broadcast to
  (B, out_cols), the frontend output's size.

Bound at B 8192, S 16000: 524.3 MB read, 0.157 ms (rowsum) and 0.162 ms
(broadcast to 600 columns) at 3.35 TB/s.  `load_rowsum` and `load_broadcast`
dispatch on the tensor they are given: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

SOURCE = "tpu_speech_commands_torch/csrc/audio_load.cu"
REPLACES = "tools/dev/r3_experiments.py:52"
BROADCAST_REPLACES = "tools/dev/r4_mxu_stage1.py:129"

# tsc_load_rowsum(audio, gain, batch, n_samples, out, stream) and
# tsc_load_broadcast(audio, gain, batch, n_samples, out, out_cols, stream)


def load_rowsum_plain(audio: torch.Tensor, gain) -> torch.Tensor:
    """(B, S) float32 audio, gain (a number or a one-element tensor) ->
    (B, 1) float32 sum(audio * gain) over each row."""
    return (audio * gain).sum(1, keepdim=True)


def load_broadcast_plain(audio: torch.Tensor, gain, out_cols: int) -> torch.Tensor:
    """The row sum of `load_rowsum_plain`, expanded to (B, out_cols)."""
    return load_rowsum_plain(audio, gain).expand(-1, out_cols).contiguous()


def _gain_tensor(gain, device) -> torch.Tensor:
    if isinstance(gain, torch.Tensor):
        if (gain.dtype != torch.float32 or gain.numel() != 1
                or gain.device != device):
            raise ValueError("gain must be one float32 value on the audio's "
                             f"device {device}")
        return gain.reshape(1)
    return torch.full((1,), float(gain), dtype=torch.float32, device=device)


def _check_audio(audio: torch.Tensor) -> None:
    if not audio.is_cuda:
        raise ValueError(f"audio must be a CUDA tensor, got {audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"audio must be float32, got {audio.dtype}")
    if audio.ndim != 2 or not audio.is_contiguous():
        raise ValueError(f"audio must be a contiguous (B, S) tensor, got "
                         f"{tuple(audio.shape)}")


def _launch(wrapper, name: str, int_args: tuple, audio: torch.Tensor, gain,
            out_cols: int, *extra) -> torch.Tensor:
    """Both wrappers (one kernel, audio_load_kernel, behind both entry
    points): check, allocate (B, out_cols), launch entry point `name` with
    `extra` before the stream, and add one to `wrapper.launches`; empty
    audio launches nothing."""
    _check_audio(audio)
    if out_cols < 1:
        raise ValueError(f"out_cols must be positive, got {out_cols}")
    gain = _gain_tensor(gain, audio.device)
    out = torch.empty((audio.shape[0], out_cols), dtype=torch.float32,
                      device=audio.device)
    if audio.numel() == 0:
        return out.zero_()
    fn = _build.bind(name, 6 + len(extra), int_args)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = fn(audio.data_ptr(), gain.data_ptr(), audio.shape[0],
                audio.shape[1], out.data_ptr(), *extra, stream)
    _build.check(rc, name)
    wrapper.launches += 1
    return out


def load_rowsum_cuda(audio: torch.Tensor, gain) -> torch.Tensor:
    """Launch the row-sum kernel: (B, S) float32 audio on a CUDA device ->
    (B, 1) float32.  Every launch adds one to `.launches`."""
    return _launch(load_rowsum_cuda, "tsc_load_rowsum", (2, 3), audio, gain, 1)


load_rowsum_cuda.launches = 0


def load_broadcast_cuda(audio: torch.Tensor, gain, out_cols: int) -> torch.Tensor:
    """Launch the broadcast kernel: (B, S) float32 audio on a CUDA device ->
    (B, out_cols) float32, every column the row sum.  Every launch adds one
    to `.launches`."""
    return _launch(load_broadcast_cuda, "tsc_load_broadcast", (2, 3, 5), audio,
                   gain, out_cols, out_cols)


load_broadcast_cuda.launches = 0


def load_rowsum(audio: torch.Tensor, gain) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if audio.device.type == "cpu":
        return load_rowsum_plain(audio, gain)
    return load_rowsum_cuda(audio, gain)


def load_broadcast(audio: torch.Tensor, gain, out_cols: int) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if audio.device.type == "cpu":
        return load_broadcast_plain(audio, gain, out_cols)
    return load_broadcast_cuda(audio, gain, out_cols)
