"""Measurement entry points of the port, the counterparts of the JAX
package's `tools/dev/` scripts whose TPU kernels the port carries:

- `pallas_experiments`: the dense-DFT frontend variants (the combined and
  halves f32 kernels, the bf16 fast_math kernel, the FFT kernel, the plain
  chain) timed at B 16384;
- `r3_experiments`: the audio-read floor (the load-only kernel) and the FFT
  frontend at B 8192;
- `r4_mxu_stage1`: the FFT kernel, the combined dense-DFT kernel and the
  load floor side by side, with each frontend's error against a float64
  reference;
- `r3_frontend_variants`, `r3_stage2`, `r3_widecell`: the CT split kernel's
  instantiations (csrc/ct_frontend.cu) that the JAX package's CT variants
  map onto, each held to the FFT kernel and timed beside it;
- `r3_omission`: the stage-omission profile, the CT split and FFT kernels
  each cut after every stage (`ops/omission_kernel.py`), streamed and
  constant-block, each cut held to its plain version and timed;
- `ct_ablation`: the CT split kernel with one part of its source cut out at
  a time, built beside the shipped library;
- `fft_ablation`: the FFT kernel's register body the same way, with one part
  cut out or one design choice undone at a time;
- `mixed_ablation`: route ct's mixed-radix FFT with one design choice undone
  at a time (launch bounds, block size, the exchange's swizzle), and a
  sweep of launch bounds x block size at every plan;
- `source_ab`: the two register-resident FFT kernels (the register body,
  route ct's mixed-radix FFT) built from another checkout's csrc/ against
  this one's, held to the plain version and timed in turns;
- `cnn_ablation`: the CNN classifier kernels the same way (the SIMT kernel
  without its L2 weight stream, the tiled implicit GEMM stopped after each
  stage), and the GEMM kernel at other tiles;
- `gru_ablation`: the GRU tile kernel with one design choice undone at a
  time (the gate math's reciprocal, the products' pipeline, the launch
  bounds, the f32 input rows), device times from CUDA graphs;
- `lstm_ablation`: the LSTM tile kernel the same way, and with two passes
  over k a step in f32;
- `block1_ablation`: the CNN block-1 kernel with one design choice undone
  at a time (the ring, the stores, the tensor cores in bf16, the tile, the
  blocks an SM) and a load-and-store cut against the K7 load floor.

Each runs on the card and raises RuntimeError where CUDA is absent:

    python -m tpu_speech_commands_torch.dev.pallas_experiments
    python -m tpu_speech_commands_torch.dev.r3_experiments --batch 8192
    python -m tpu_speech_commands_torch.dev.r4_mxu_stage1 --batch 8192
    python -m tpu_speech_commands_torch.dev.r3_frontend_variants --batch 8192
    python -m tpu_speech_commands_torch.dev.r3_stage2 --batch 8192
    python -m tpu_speech_commands_torch.dev.r3_widecell --batch 8192
    python -m tpu_speech_commands_torch.dev.r3_omission --batch 8192
    python -m tpu_speech_commands_torch.dev.ct_ablation
    python -m tpu_speech_commands_torch.dev.fft_ablation
    python -m tpu_speech_commands_torch.dev.mixed_ablation
    python -m tpu_speech_commands_torch.dev.source_ab --other DIR/csrc
    python -m tpu_speech_commands_torch.dev.cnn_ablation
    python -m tpu_speech_commands_torch.dev.gru_ablation
    python -m tpu_speech_commands_torch.dev.lstm_ablation
    python -m tpu_speech_commands_torch.dev.block1_ablation

Their `make_*` functions take `device="cpu"` for the plain versions.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops.ct_kernel import CtConstants, ct_frontend


def graph_ms(fn, iters: int = 20) -> float:
    """The device time of one call of fn: `iters` calls captured in a CUDA
    graph and replayed between two events.  Back-to-back calls time the
    host instead where a call's host work outlasts its kernel."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_audio(batch: int, n_samples: int, seed: int, device) -> torch.Tensor:
    """(batch, n_samples) float32 standard-normal audio from a numpy seed,
    made on the host in one piece and copied to `device`."""
    rng = np.random.default_rng(seed)
    return torch.tensor(
        rng.standard_normal((batch, n_samples), dtype=np.float32), device=device)


def best_rate(fn, audio: torch.Tensor, gains: torch.Tensor,
              repeats: int = 1) -> float:
    """Best windows/s over `repeats` runs of fn(audio, gains[i:i + 1]) for
    every gain in turn, timed with CUDA events after one warm-up call.  Each
    output is summed into an on-device checksum, fetched at the end;
    RuntimeError if it is not finite."""
    checksum = torch.zeros((), dtype=torch.float32, device=audio.device)
    checksum += fn(audio, gains[0:1]).sum()  # warm-up
    best = 0.0
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(len(gains)):
            checksum += fn(audio, gains[i:i + 1]).sum()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        best = max(best, len(gains) * audio.shape[0] / seconds)
    if not torch.isfinite(checksum).item():
        raise RuntimeError("the checksum is not finite")
    return best


# f32 features from two kernels that sum in another order, magnified by the
# log of a small mel energy: the bound the port's f32 features are held to
FEAT_ATOL, FEAT_RTOL = 2e-3, 1e-3


def check_features(label: str, got: torch.Tensor, want: torch.Tensor,
                   atol: float = FEAT_ATOL, rtol: float = FEAT_RTOL) -> float:
    """max|got - want|; RuntimeError if `got` is not finite or an element is
    further from `want` than atol + rtol |want|."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise RuntimeError(f"{label}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{label}: output is not finite")
    diff = (got - want).abs()
    if (diff > atol + rtol * want.abs()).any():
        raise RuntimeError(f"{label}: max|delta| {float(diff.max()):.2e} "
                           f"outside atol {atol:g} + rtol {rtol:g}")
    return float(diff.max())


def ct_variant(p, device, paired: bool, per_piece_mel: bool,
               time_major: bool):
    """fn(audio, gain) -> features: one instantiation of the CT split kernel
    (forced: route ct runs the mixed-radix FFT where it takes the config)
    for config `p` on `device` (the plain version on the CPU)."""
    consts = CtConstants(p, "mfcc", device)
    return lambda audio, gain=None: ct_frontend(
        audio, gain, consts, p, paired, per_piece_mel, time_major, _split=True)
