#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA; print the card's name and power limit (nvidia-smi)
2. build    compile tpu_speech_commands_torch/csrc/*.cu with nvcc (sm_90a)
3. kernels  each kernel against its plain PyTorch version on the card, at
            B = 1000, over the configs and dtypes the slices can meet (the
            GRU and LSTM classifiers' tile kernels and their SIMT kernels,
            `_simt=True`, one layer pretrained and two random, f32 and bf16,
            and the tile kernels' reciprocal against the true divide on
            every float of [1, inf]; the
            CNN classifier's tiled implicit GEMM and its SIMT kernel,
            `_simt=True`, at four model x shape cases, f32 and bf16; the
            CNN block-1 kernel and its first design (`_simt=True`) for both
            CNN checkpoints, f32 and bf16 compute on f32 and bf16 features;
            the
            fast_math frontend's wgmma kernel and its first design
            (`_mma_sync=True`) at every frontend case, and at K6
            make_bf16_kernel's own settings;
            the f32 dense-DFT kernels at the default config and at W 800,
            combined, or W = 2 hop = 800, halves, and combined with a gain
            and a first frame; the load-floor kernels at gains 1 and 1.5;
            the CT split kernel's four instantiations (`_split=True`) at the
            default config, batch- and time-major, and at n_fft = window =
            768 with deltas, int16 in and bf16 out; route ct's mixed-radix
            FFT at every n_fft it takes (768 .. 3840), f32 and int16 in,
            f32 and bf16 out, batch- and time-major, with and without
            deltas, against the CT plain version; route ct's split-dup
            body (the split's (F, T) instantiation) at n_fft 4352, 10240
            and 15872 in the same four cases; the FFT kernel at window
            1200 > n_fft,
            at alt_512 and an odd hop of 481, at every n_fft its register
            body takes (128 .. 4096) and at 8192 (its radix-2 body), f32
            and int16 in, f32 and bf16 out, and its radix-2 body at the
            default config; every stage cut of the CT split and FFT
            kernels, streamed and constant-block, at B = 1008 on f32
            audio, and on int16 at `full`)
4. slices   each path driven on the eight example/*.wav clips in f32 and
            bf16, with every launch count set to 0 just before it and read
            just after:
            - make_batch_scorer for direction_simple_gru.npz,
              direction_simple_lstm.npz, direction_simple_cnn.npz and
              direction_simple_cnn_lite.npz: top-1 must equal every file's
              label, `.paths` must name both kernels, both launch counts
              must rise (for simple_gru and simple_lstm the tile kernel's,
              the SIMT kernel's staying at 0), and the scores must agree
              with the same scorer run on the CPU (plain versions);
            - the SIMT GRU and LSTM classifiers kept for the A/B (frontend
              kernel, then GRUClassifier / LSTMClassifier(..., _simt=True)):
              top-1 and its launch count;
            - the fused-block-1 path (frontend kernel, then
              make_fused_cnn_forward) for both CNN checkpoints: top-1 and the
              block-1 launch count (the SIMT block-1 kernel's at 0);
            - the SIMT block-1 kernel kept for the A/B (frontend kernel,
              cnn_block1_cuda(..., _simt=True), then the model's blocks 2-4)
              for both CNN checkpoints: top-1 and its launch count;
            - the SIMT CNN classifier kept for the A/B (frontend kernel, then
              cnn_classifier_cuda(..., _simt=True)) for both CNN checkpoints:
              top-1 and its launch count;
            - MfccFrontend(fast_math=True) into the GRU, LSTM and CNN
              classifier kernels for all four checkpoints: top-1 and both
              launch counts (the first fast_math design's at 0); that
              design (`_mma_sync=True`) into the GRU kernel: top-1 and its
              count;
            - make_batch_scorer for direction_simple_gru.npz with its params
              set to the classes of config the route choice covers:
              n_fft = window = 768 (route cuda-ct, the mixed-radix FFT; the
              CT split's launch counts must stay at 0), window
              1200 > n_fft 1024 (cuda-mfcc, the FFT kernel's register
              body), n_fft 8192 (cuda-mfcc, its radix-2 body), n_fft 400
              (torch(xla-route), the plain chain) and n_fft = window = 4352
              (cuda-ct(split-dup)): `.paths` must name the
              route, its kernels' launch counts must rise, and the scores
              must agree with the same scorer on the CPU;
            - the seven measurement entry points of tpu_speech_commands_torch
              .dev at their own batch (pallas_experiments B = 16384, every
              variant; the others B = 8192), a few iterations each: every
              checksum finite, r4's two frontends (dense: the gain applied,
              the last n_features frames) within its stated bound of a
              float64 reference, the CT variants within the f32 feature
              bound of the FFT kernel, r3_omission's cuts within their
              stage's bound of the plain version, and the dense-DFT,
              load-floor, CT and stage-cut launch counts must rise
5. times    CUDA-event times at B = 8192, audio resident on the card (the
            dense-DFT, load-floor and CT kernels are first held to their
            plain versions at this batch, their entry points' own, with the
            phase-3 tolerances; the FFT kernel's register body is timed
            against its radix-2 body in turns, radix-2, register, register,
            radix-2, the CT kernel's (F, F) instantiation against the
            FFT kernel in turns, fft, ct, ct, fft, route ct's mixed-radix FFT
            against the CT split's (F, F) in turns, new, split, split, new,
            at n_fft = window = 768 (hop 512) and 1536 (hop 256), and against
            its plain version alone at 2816 (hop 256: the split refuses it),
            each beside its bound, the fast_math wgmma kernel against
            its first design in turns, mma_sync, wgmma, wgmma, mma_sync,
            beside the bound, the plain version and the DFT product alone
            through cuBLAS (a yardstick), route ct's split-dup body at
            n_fft 4352 beside its bound and the CT plain version, the GRU classifier's tile
            kernel against its SIMT kernel in turns, simt, tile, tile, simt,
            in f32 and bf16 (bf16 features), with a sweep of the tile
            kernel's windows a warp and warps a block and the gate math's
            SFU floor beside the bound, the LSTM classifier's tile kernel
            against its SIMT kernel the same way (device times, f32 and
            bf16, each beside its bound, the SFU floor and cuDNN's
            nn.LSTM in the same dtype), and the CNN classifier's
            tiled implicit GEMM against its SIMT kernel in turns, simt, gemm,
            gemm, simt, for both CNN checkpoints' models in f32 and bf16, each
            beside its own bound, `cnn_bound`; the CNN block-1 kernel
            against its SIMT kernel in turns, simt, new, new, simt, f32 and
            bf16 compute on f32 features, device times, beside the bound
            (its bytes and operations parts), the plain version, F.conv2d
            alone (cuDNN, TF32 off; a yardstick for part of the function)
            and make_fused_cnn_forward end to end for simple_cnn, with the
            block-1 kernel's share of it): each
            kernel against its plain version (the fast_math frontend also
            against the FFT kernel), the one PyTorch call that computes the
            same function where there is one (torch.sum for the load
            floor's row sum, cuDNN nn.LSTM for the LSTM layer), each
            kernel's bound (the larger of its operations over the card's
            peak rate for their type and its bytes over 3.35 TB/s; a
            frontend's FFT counted as a real-input transform, its
            filterbank over the packed nonzero weights; the CT split
            kernels and the mixed-radix FFT take the FFT kernel's bound at
            their config (`frontend_bound`), as they compute its
            function, and the CT split's own operations are printed apart
            as that algorithm's floor), end-to-end windows/s for every
            scorer and for the simple_gru scorer at n_fft = window = 768
            (first held to the CPU scorer on the clips), f32 and bf16
            (information only), and every stage cut of both
            frontend kernels, streamed and constant-block, held to its
            plain version and timed beside it and its bound (`cut_bounds`),
            with the per-stage deltas: the streamed `load` cuts must take at
            least 0.9x the load floor's time (they read every sample), and
            each `full` cut is timed in turns with its shipped kernel

Two lines before the last: one JSON object describing each kernel, then the
card's name and power limit; the last line is {"ok": true, "device":
{...}}.  On a machine without CUDA the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time
import wave

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")
LSTM_CHECKPOINT = os.path.join(REPO, "pretrained", "direction_simple_lstm.npz")
CNN_CHECKPOINTS = {m: os.path.join(REPO, "pretrained", f"direction_{m}.npz")
                   for m in ("simple_cnn", "simple_cnn_lite")}
B_CHECK = 1000   # not a multiple of any tile either kernel uses
B_CUT = 1008     # the stage cuts take multiples of 16: a multiple of no other tile
B_TIME = 8192    # the serving batch the JAX benchmark measured
# route ct's config on the main path: n_fft = window = 768, the smallest the
# JAX scorer runs on its CT kernel (the mixed-radix FFT takes it on the card)
CT_ROUTE = {"n_fft": 768, "window_t": 0.048}
# the A/B configs of the mixed-radix FFT against the CT split and its plain
# version: at hop 512 n_fft 1536 and 2816 give 29 and 26 frames, so these
# run at hop 256 (57 and 52 frames); the split refuses 2816
CT_AB = ((768, 0.032), (1536, 0.016), (2816, 0.016))
# route ct above n_fft 4096 (the CT split's (F, T) instantiation): the first
# size, one between and the longest window a 1 s buffer holds (one frame);
# the simple_gru scorer and the timing at the first
SPLIT_DUP = (4352, 10240, 15872)
SPLIT_DUP_ROUTE = {"n_fft": 4352, "window_t": 0.272}

# Tolerances, each with its reason:
# - features f32: the kernel's radix-2 FFT and the plain dense-DFT matmul
#   sum in different orders, and the log of a small mel energy magnifies
#   the difference; the bound tests/test_frontend_jax.py holds the f32
#   frontend to against the float64 oracle.  main() imports it from the
#   port (tpu_speech_commands_torch.dev: FEAT_ATOL, FEAT_RTOL), whose
#   measurement entry points hold their features to the same bound.
# - features bf16: the f32 bound plus one bf16 rounding step (2^-7 relative)
BF16_STEP = 2.0 ** -7
# (the fast_math frontend kernel is held to the same two bounds: its frames
# and DFT matrix are the plain version's bf16 values bit for bit, and only
# the f32 sums run in another order)
# - GRU and LSTM logits f32 (tile and SIMT kernels): same math, f32 sums
#   in another order over 30 steps
GRU_ATOL, GRU_RTOL = 1e-4, 1e-5
# - GRU and LSTM logits bf16: rounding of bf16 products can flip at a
#   boundary and grow over the recurrence; the bound tests/test_serving.py
#   allows bf16
GRU_BF16_ATOL = 5e-2
# - scores f32, card vs CPU: the feature bound carried through the GRU
SCORE_ATOL = 1e-3
SCORE_BF16_ATOL = 5e-2
# - CNN logits f32: same math, f32 sums in another order over K <= 576
CNN_ATOL, CNN_RTOL = 1e-4, 1e-5
# - CNN logits bf16: a bf16 rounding of an activation can flip when two f32
#   sums differ in the last bit; the bound tests/test_serving.py allows bf16
CNN_BF16_ATOL = 5e-2
# - CNN block-1 activations f32: one conv of 9 taps, another order
BLOCK1_ATOL, BLOCK1_RTOL = 1e-5, 1e-5
BLOCK1_BF16_ATOL = 5e-2
# - dense-DFT features (K6 :76, :188): the f32 feature bound above, the same
#   f32 math in another summation order, magnified by the log
# - load-floor row sums (K7): per row |err| <= LOAD_REL * sum |gain * x|,
#   16,000 f32 terms summed in another order (eps * log2(16000) ~ 8.4e-7);
#   a bare atol would be wrong, the sums reach the hundreds
LOAD_REL = 2e-6
# Published peaks of one H100 SXM (dense, at 700 W), for the kernels' bounds
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
# The special-function units: 16 results a clock an SM, 132 SMs, at the
# 1.98 GHz boost clock (the least time); information beside the RNN bounds
SFU_RATE = 16 * 132 * 1.98e9
# The plain versions' convs run through cuDNN, which takes float32 convs in
# TF32 unless torch.backends.cudnn.allow_tf32 is False: main() sets it (and
# the matmul flag) False, so every float32 reference here is float32.


def log(msg: str = "") -> None:
    print(msg, flush=True)


def load_clips():
    """The example clips as (8, 16000) int16, left-padded or tail-trimmed
    to 16000 samples, and their labels from the file names."""
    clips, labels = [], []
    for path in sorted(glob.glob(os.path.join(REPO, "example", "*.wav"))):
        with wave.open(path, "rb") as wf:
            if wf.getsampwidth() != 2 or wf.getnchannels() != 1:
                raise ValueError(f"{path}: need mono 16-bit PCM")
            pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        pcm = pcm[-16000:]
        clips.append(np.pad(pcm, (16000 - len(pcm), 0)))
        labels.append(os.path.basename(path).split("_")[0])
    if len(clips) != 8:
        raise FileNotFoundError(f"expected 8 example clips, found {len(clips)}")
    return np.stack(clips), labels


def test_audio(clips: np.ndarray, batch: int, seed: int) -> np.ndarray:
    """(batch, 16000) float32: the example clips at random gains plus a
    little noise, so features look like speech, not white noise."""
    rng = np.random.default_rng(seed)
    base = clips.astype(np.float32) / 32768.0
    rows = base[np.arange(batch) % len(base)]
    gains = rng.uniform(0.3, 1.5, (batch, 1)).astype(np.float32)
    noise = 0.003 * rng.standard_normal(rows.shape).astype(np.float32)
    return np.clip(rows * gains + noise, -1.0, 32767 / 32768).astype(np.float32)


def with_params(path: str, overrides: dict, out_dir: str) -> str:
    """A copy of checkpoint `path` in out_dir whose stored params carry
    `overrides` (the loader applies them to the frontend it builds)."""
    data = dict(np.load(path))
    meta = json.loads(bytes(data["__meta__"]))
    meta["params"].update(overrides)
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    tag = "_".join(f"{k}{v}" for k, v in sorted(overrides.items()))
    out = os.path.join(out_dir, f"{os.path.basename(path)[:-4]}_{tag}.npz")
    np.savez(out, **data)
    return out


def check_close(what, got, want, atol, rtol) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    max_err = float(err.max())
    excess = float((err - (atol + rtol * want.abs())).max())
    log(f"  {what:46s} max_abs_err {max_err:.3e}  "
        f"(atol {atol:g}, rtol {rtol:g})")
    if excess > 0:
        raise AssertionError(f"{what}: error {max_err:.3e} outside tolerance")
    return max_err


def check_rowsum(what, got, want, audio, gain) -> float:
    """The load-floor bound: per row |got - want| <= LOAD_REL * sum |g x|."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.isfinite().all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    bound = LOAD_REL * (audio * gain).abs().sum(1, keepdim=True)
    max_err = float(err.max())
    log(f"  {what:46s} max_abs_err {max_err:.3e}  (per row <= {LOAD_REL:g} "
        f"x sum |gain x|, max bound {float(bound.max()):.3e})")
    if not (err <= bound).all():
        raise AssertionError(f"{what}: error {max_err:.3e} outside tolerance")
    return max_err


def bound_ms(flops_f32=0.0, flops_bf16=0.0, nbytes=0.0):
    """(ms, "operations" | "bytes"): the least time the card could take, the
    larger of the operations over the peak rate for their type and the
    bytes over the memory rate."""
    ops = flops_f32 / PEAK_F32 + flops_bf16 / PEAK_BF16
    mem = nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


def frontend_ops(p, frames):
    """(FFT, cepstrum) operations of the exact frontend over `frames` frames
    at config p: a real-input FFT of n_fft points is half a complex one's 5
    n log2 n (the nominal count of a mixed-radix one where n_fft is not a
    power of two); the cepstrum is the power and energy (4 a bin), the
    filterbank over its packed nonzero weights (as every frontend kernel
    applies it) and the DCT, f32 on the CUDA cores."""
    import math

    from tpu_speech_commands_torch.frontend.filterbanks import filterbank_matrix
    from tpu_speech_commands_torch.ops.frontend_kernel import pack_filterbank

    n_packed = len(pack_filterbank(filterbank_matrix(p, "mfcc").T)[0])
    fft = frames * 2.5 * p.n_fft * math.log2(p.n_fft)
    return fft, frames * (4 * p.n_fft_bins + 2 * n_packed
                          + 2 * p.n_filt * p.n_mfcc)


def audio_span(p):
    """The samples of a window that the frontend's function reads at config
    p: the kept frames' span, (n_features - 1) hops and one frame's window
    (cut to n_fft).  The samples before the first kept frame and after the
    last are not needed."""
    return (p.n_features - 1) * p.hop_samples + min(p.window_samples, p.n_fft)


def frontend_bound(p, batch):
    """The exact frontend's bound at config p on `batch` windows of f32
    audio: the larger of its operations (`frontend_ops`) at the f32 peak and
    its bytes (the kept frames' span of audio read once, `audio_span`, the
    features written once)."""
    frames = batch * p.n_features
    return bound_ms(sum(frontend_ops(p, frames)), 0,
                    4.0 * batch * audio_span(p) + 4.0 * frames * p.feature_size)


def dft_bound(p, batch):
    """The fast_math frontend's bound at config p on `batch` windows of f32
    audio: the DFT's nonzero columns (cos of every bin and sin of all but
    bin 0 and the Nyquist bin, n_fft in all) over the kept frames at the
    bf16 peak, the cepstrum at the f32 peak, against the kept frames' span
    of audio read once and the features written once."""
    frames = batch * p.n_features
    dft = frames * 2.0 * min(p.window_samples, p.n_fft) * p.n_fft
    return bound_ms(frontend_ops(p, frames)[1], dft,
                    4.0 * batch * audio_span(p) + 4.0 * frames * p.feature_size)


def block1_bound(batch, stage):
    """CNN block 1's bound: (ms, by, bytes ms, operations ms).  Its f32
    features read once and its f32 NHWC output written once; 2 FLOP a tap
    and channel at every conv position (the 2x2 pool keeps them all at even
    dimensions), at the f32 peak (bf16 mode runs its FMAs in f32 too)."""
    from tpu_speech_commands_torch.models.cnn import conv_out

    flops = (batch * 2.0 * 9 * stage.cin * stage.cout
             * conv_out(stage.h_in, stage.stride) * conv_out(stage.w_in, stage.stride))
    nbytes = 4.0 * batch * (stage.h_in * stage.w_in
                            + stage.h_out * stage.w_out * stage.cout)
    return (*bound_ms(flops, 0, nbytes), nbytes / PEAK_BYTES * 1e3,
            flops / PEAK_F32 * 1e3)


def kernel_bounds(p, batch, n_samples, rnn_dims, cnn_consts):
    """Each timed kernel's bound at the phase-5 shapes: f32 audio (batch,
    n_samples) into the frontends and the load floor (route ct's kernel at
    CT_ROUTE, the others at p); (batch, T, F) f32 features into the
    classifiers (times are f32)."""
    from tpu_speech_commands_torch.ops.ct_kernel import VARIANTS

    frames = batch * p.n_features
    audio_b = 4.0 * batch * n_samples  # the load kernels read whole rows
    span_b = 4.0 * batch * audio_span(p)  # the frontends, the kept frames
    feats_b = 4.0 * frames * p.feature_size
    cepstrum = frontend_ops(p, frames)[1]
    # the DFT's nonzero columns: cos of every bin and sin of all but bin 0
    # and the Nyquist bin, n_fft in all
    dft = frames * 2.0 * min(p.window_samples, p.n_fft) * p.n_fft
    block1 = block1_bound(batch, cnn_consts.stages[0].stage)[:2]
    gru = rnn_bound(batch, rnn_dims, 3, "float32")
    lstm = rnn_bound(batch, rnn_dims, 4, "float32")
    cnn = cnn_bound(cnn_consts.lowered, False, batch, "float32")
    # the FFT kernel's two bodies and the CT split kernel compute one
    # function: one bound (the CT split's own algorithm's floor is
    # ct_split_flops, information only)
    frontend = frontend_bound(p, batch)
    return {
        **dict.fromkeys(VARIANTS, frontend),
        "mixed_fft_frontend": frontend_bound(p.replace(**CT_ROUTE), batch),
        "mfcc_frontend": frontend,
        "mfcc_frontend_radix2": frontend,
        "dft_frontend_bf16": dft_bound(p, batch),
        "dft_frontend_mma_sync": dft_bound(p, batch),
        "gru_classifier": gru,
        "gru_classifier_simt": gru,
        "lstm_classifier": lstm,
        "lstm_classifier_simt": lstm,
        "cnn_classifier": cnn,
        "cnn_classifier_simt": cnn,
        "cnn_block1": block1,
        "cnn_block1_simt": block1,
        "dense_dft_combined": bound_ms(dft + cepstrum, 0, span_b + feats_b),
        "dense_dft_halves": bound_ms(dft + cepstrum, 0, span_b + feats_b),
        "load_rowsum": bound_ms(2.0 * batch * n_samples, 0,
                                audio_b + 4.0 * batch),
        "load_broadcast": bound_ms(
            2.0 * batch * n_samples, 0,
            audio_b + 4.0 * batch * p.n_features * p.n_mfcc),
    }


def rnn_bound(batch, rnn_dims, gates: int, dtype: str):
    """A GRU (3 gates) or LSTM (4) layer with its head, (T, D, U, C) =
    rnn_dims, in a compute dtype: [x_t | h] @ [W; U] over the steps and the
    head, 2 a multiply-add; "float32" at the f32 peak on f32 features,
    "bfloat16" at the bf16 tensor-core peak on bf16 features (as the bf16
    scorer hands them over); logits f32.  The gate math is left out (its
    SFU floor is `sfu_floor_ms`)."""
    steps, d_in, units, classes = rnn_dims
    ops = (batch * steps * 2.0 * gates * units * (d_in + units)
           + batch * 2.0 * units * classes)
    nbytes = batch * (steps * d_in * (4 if dtype == "float32" else 2)
                      + 4 * classes)
    if dtype == "float32":
        return bound_ms(ops, 0, nbytes)
    return bound_ms(0, ops, nbytes)


def sfu_floor_ms(batch, rnn_dims, per_unit_step: int) -> float:
    """The special-function results an RNN's gate math needs (an exp and a
    reciprocal a sigmoid or tanh: 4 a unit a step for the GRU's two
    sigmoids, 10 for the LSTM's three sigmoids and two tanh), at SFU_RATE:
    information, not part of the bound."""
    steps, _, units, _ = rnn_dims
    return batch * steps * units * per_unit_step / SFU_RATE * 1e3


def cnn_flops(lowered, separable: bool) -> float:
    """The operations a window of the CNN classifier needs: each conv at the
    positions the VALID pool keeps (block 2 keeps 140 of 150 at 30 x 20,
    block 4 8 of 12), 2 a multiply-add; a separable block in the separable
    form the function needs (depthwise 9 cin, pointwise cin cout a
    position), not the composed dense kernel the kernels run; the dense
    layer and the head."""
    flops = 0.0
    for st in lowered.stages:
        kept = st.h_out * st.w_out * (4 if st.pool else 1)
        per = 9 * st.cin + st.cin * st.cout if separable else \
            9 * st.cin * st.cout
        flops += 2.0 * per * kept
    flat, hidden = lowered.dense_w.shape
    return flops + 2.0 * flat * hidden + 2.0 * hidden * lowered.head_w.shape[1]


def cnn_bound(lowered, separable: bool, batch: int, dtype: str):
    """The CNN classifier's bound in a compute dtype ("float32": the f32
    peak, f32 features; "bfloat16": the bf16 tensor-core peak, bf16
    features, as the call reads them), logits f32."""
    st = lowered.stages[0]
    ops = batch * cnn_flops(lowered, separable)
    nbytes = batch * (st.h_in * st.w_in * (4 if dtype == "float32" else 2)
                      + 4 * lowered.head_w.shape[1])
    if dtype == "float32":
        return bound_ms(ops, 0, nbytes)
    return bound_ms(0, ops, nbytes)


def cut_bounds(p, batch, n_samples, constant_block):
    """Each stage cut's bound (ops/omission_kernel.py) on (batch, n_samples)
    f32 audio, by name (`counter_name`).  Bytes: the audio read once
    (constant block: block 0's 16 rows) and the (batch, 128) f32 output.
    Operations: what the cut's function needs, counted as kernel_bounds
    counts the frontend: the load's scale and add a sample (as the load
    floor); framing, one add a sample into its lane's plane sum; the
    butterfly, stage 1's 24 operations a lane (as ct_split_flops); from
    power on, the real FFT, 4 a bin (|X|^2 and its fold), then 2 a packed
    filterbank weight, one log a mel lane and the DCT.  A stage's CT and FFT
    cuts compute one function and share its bound."""
    import math

    from tpu_speech_commands_torch.frontend.filterbanks import filterbank_matrix
    from tpu_speech_commands_torch.ops import omission_kernel
    from tpu_speech_commands_torch.ops.frontend_kernel import pack_filterbank

    n_frames = 1 + (n_samples - p.n_fft) // p.hop_samples
    frames = batch * n_frames
    n_packed = len(pack_filterbank(filterbank_matrix(p, "mfcc").T)[0])
    rows = omission_kernel.BATCH_TILE if constant_block else batch
    nbytes = 4.0 * rows * n_samples + 4.0 * batch * omission_kernel.LANES
    power = frames * (2.5 * p.n_fft * math.log2(p.n_fft) + 4 * p.n_fft_bins)
    mel = power + frames * 2.0 * n_packed
    log_ = mel + frames * (p.n_filt + 1.0)
    ops = {
        "load": 2.0 * batch * n_samples,
        "framing": frames * float(p.n_fft),
        "butterfly": frames * 128.0 * 24,
        "power": power,
        "mel": mel,
        "log": log_,
        "full": log_ + frames * 2.0 * p.n_filt * p.n_mfcc,
    }
    return {omission_kernel.counter_name(k, s): bound_ms(ops[s], 0, nbytes)
            for k, stages in omission_kernel.KERNELS.items() for s in stages}


def ct_split_flops(p, batch, per_piece_mel=False) -> float:
    """The operations the CT split algorithm does on (batch, 16000) audio,
    a floor of that algorithm and not of the function (a real FFT needs
    ~15x fewer at n_fft 1024): stage 2, 2 + 2 (n2 - 2) products of 128 x 128
    a frame; stage 1, the n2 = 8 butterfly's 24 operations a lane, else the
    tables' n2 multiply-adds for each of n2 values; the packed cepstrum,
    whose filterbank term the per-piece mel doubles (it runs on Xr^2 and
    Xi^2)."""
    from tpu_speech_commands_torch.frontend.filterbanks import filterbank_matrix
    from tpu_speech_commands_torch.ops.frontend_kernel import pack_filterbank

    frames = batch * p.n_features
    n2 = p.n_fft // 128
    n_packed = len(pack_filterbank(filterbank_matrix(p, "mfcc").T)[0])
    stage2 = frames * (2 + 2 * (n2 - 2)) * 128 * 128 * 2.0
    stage1 = frames * 128.0 * (24 if n2 == 8 else 2 * n2 * n2)
    ceps = frames * (4 * p.n_fft_bins
                     + 2 * n_packed * (2 if per_piece_mel else 1)
                     + 2 * p.n_filt * p.n_mfcc)
    return stage2 + stage1 + ceps


def cudnn_lstm(model, device, dtype=None):
    """The library yardstick of the LSTM kernel: torch.nn.LSTM (cuDNN) with
    the one-layer Keras LSTM's weights (same gate order; the single Keras
    bias as bias_ih), in `dtype` (float32 by default).  Timed here only; the
    port never calls it."""
    import torch

    cell = model.backbone.lstm_unit_0
    lstm = torch.nn.LSTM(cell.kernel.shape[0], cell.units, batch_first=True)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(cell.kernel.T)
        lstm.weight_hh_l0.copy_(cell.recurrent_kernel.T)
        lstm.bias_ih_l0.copy_(cell.bias)
        lstm.bias_hh_l0.zero_()
    lstm = lstm.to(device, dtype).eval()
    lstm.flatten_parameters()  # one weight buffer, as cuDNN wants it
    return lstm


def random_cnn(cls, h: int, w: int, seed: int, device):
    """A `cls` CNN (5 classes, h x w input) with weights and BatchNorm
    statistics from a numpy seed; some BatchNorm scales are negative, as
    after training."""
    import torch

    model = cls(5, h, w)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("bn.var"):
                val = rng.uniform(0.5, 2.0, t.shape)
            elif name.endswith("bn.scale"):
                val = rng.normal(1.0, 0.6, t.shape)
            else:
                fan_in = int(np.prod(t.shape[:-1])) if t.ndim > 1 else 10
                val = rng.standard_normal(t.shape) / np.sqrt(fan_in)
            t.copy_(torch.tensor(val, dtype=torch.float32))
    return model.to(device).eval()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tpu_speech_commands_torch.frontend.dsp import Frontend, frame_signal
    from tpu_speech_commands_torch.models import score_fn
    from tpu_speech_commands_torch.models.cnn import SimpleCNN, SimpleCNNLite
    from tpu_speech_commands_torch.models.rnn import SimpleGRU, SimpleLSTM
    from tpu_speech_commands_torch.dev import (
        FEAT_ATOL, FEAT_RTOL, card_line, graph_ms, pallas_experiments,
        r3_experiments, r3_frontend_variants, r3_omission, r3_stage2,
        r3_widecell, r4_mxu_stage1)
    from tpu_speech_commands_torch.ops import (
        _build, cnn_kernel, ct_kernel, dense_dft_kernel, fft_plan,
        frontend_kernel, gru_plan, load_kernel, omission_kernel, rnn_kernel)
    from tpu_speech_commands_torch.ops.cnn_kernel import (
        CNNClassifier, make_fused_cnn_forward)
    from tpu_speech_commands_torch.ops.cnn_lowering import lower_block1
    from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
    from tpu_speech_commands_torch.ops.rnn_kernel import (
        GRUClassifier, LSTMClassifier)
    from tpu_speech_commands_torch.params import ListenerParams
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.serving import make_batch_scorer

    FEAT_BF16_ATOL, FEAT_BF16_RTOL = FEAT_ATOL, FEAT_RTOL + BF16_STEP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)  # inference only: no autograd graphs
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}  count {torch.cuda.device_count()}  torch "
        f"{torch.__version__}  cuda {torch.version.cuda}")
    log(card)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    log(f"build: {time.perf_counter() - t0:.1f} s (compiled in this run: "
        f"{info.compiled}) -> {os.path.relpath(info.path, REPO)}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    # -- 3. kernels against their plain versions ------------------------------
    clips, labels = load_clips()
    audio_np = test_audio(clips, B_CHECK, seed=0)
    audio_f32 = torch.tensor(audio_np, device=dev)
    audio_i16 = torch.tensor(
        np.clip(np.round(audio_np * 32768.0), -32768, 32767).astype(np.int16),
        device=dev)
    log(f"kernels vs plain on the card, B = {B_CHECK}, TF32 off:")
    cases = [
        ("default", {}, "mfcc", audio_f32, torch.float32, 0.8),
        ("default", {}, "mfcc", audio_i16, torch.float32, 1.25),
        ("default", {}, "mfcc", audio_f32, torch.bfloat16, 0.8),
        ("default", {}, "mfcc", audio_i16, torch.bfloat16, 1.0),
        ("use_delta", {"use_delta": True}, "mfcc", audio_f32, torch.float32, 0.8),
        ("use_delta", {"use_delta": True}, "mfcc", audio_i16, torch.bfloat16, 1.25),
        ("window_t=0.05", {"window_t": 0.05}, "mfcc", audio_f32, torch.float32, 0.8),
        ("window_t=0.05", {"window_t": 0.05}, "mfcc", audio_i16, torch.float32, 1.0),
        ("hop_t=0.03", {"hop_t": 0.03}, "mfcc", audio_f32, torch.float32, 1.0),
        ("bark", {}, "bark", audio_f32, torch.float32, 0.8),
        ("bark", {}, "bark", audio_i16, torch.bfloat16, 1.25),
    ]
    frontend_errs, fast_errs, mma_sync_errs = [], [], []
    for name, kw, ftype, audio, out_dtype, gain in cases:
        p = ListenerParams(**kw)
        for fast_math, errs in ((False, frontend_errs), (True, fast_errs)):
            fe = MfccFrontend(p, ftype, dev, out_dtype=out_dtype,
                              fast_math=fast_math)
            runs = {"": lambda: fe(audio, gain)}
            if fast_math:  # the first design too, the wgmma kernel's A/B
                runs[" (mma_sync)"] = lambda: frontend_kernel.\
                    dft_frontend_bf16_cuda(
                        audio, torch.full((1,), gain, device=dev), fe.consts,
                        p, out_dtype, _mma_sync=True)
            want = fe.plain(audio, gain).to(out_dtype)
            for which, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                assert got.dtype == out_dtype
                what = (f"{'fast_math' if fast_math else 'frontend'}{which} "
                        f"{name} {ftype} {str(audio.dtype)[6:]}->"
                        f"{str(out_dtype)[6:]} gain {gain}")
                if out_dtype == torch.float32:
                    (mma_sync_errs if which else errs).append(
                        check_close(what, got, want, FEAT_ATOL, FEAT_RTOL))
                else:
                    check_close(what, got, want, FEAT_BF16_ATOL,
                                FEAT_BF16_RTOL)
    # K6 make_bf16_kernel's own settings: default params, f32 audio at
    # gain 1, f32 output over all 30 frames; both fast_math kernels
    fe = MfccFrontend(ListenerParams(), "mfcc", dev, fast_math=True)
    want = fe.plain(audio_f32)
    fast_errs.append(check_close(
        "fast_math at K6 make_bf16_kernel's settings", fe(audio_f32), want,
        FEAT_ATOL, FEAT_RTOL))
    mma_sync_errs.append(check_close(
        "fast_math (mma_sync) at K6 make_bf16_kernel's settings",
        frontend_kernel.dft_frontend_bf16_cuda(
            audio_f32, torch.ones(1, device=dev), fe.consts, ListenerParams(),
            _mma_sync=True), want, FEAT_ATOL, FEAT_RTOL))

    feats = Frontend(ListenerParams(), "mfcc", dev)(audio_f32)
    pretrained = load_native(CHECKPOINT, dev).model
    lstm_pretrained = load_native(LSTM_CHECKPOINT, dev).model
    rng = np.random.default_rng(1)

    def random_rnn(cls):
        model = cls(5, 20, 48, num_layers=2).to(dev)
        with torch.no_grad():
            for prm in model.parameters():
                prm.copy_(torch.tensor(
                    0.1 * rng.standard_normal(tuple(prm.shape)),
                    dtype=torch.float32))
        return model

    # the tile kernel's sigmoid takes a reciprocal without the division's
    # branch: it must be the true divide on each float of [1, inf]
    mismatches = rnn_kernel.gru_rcp_mismatches(dev)
    log(f"  gru tile kernel's reciprocal vs 1.0f / d on every float of "
        f"[1, inf]: {mismatches} differ")
    if mismatches:
        raise AssertionError("the GRU tile kernel's reciprocal is not the "
                             "true divide")
    # the GRU's and the LSTM's tile kernels (what GRUClassifier and
    # LSTMClassifier launch) and the SIMT kernels kept for the A/B, each held
    # to the plain version
    gru_models = (("1 layer, pretrained", pretrained),
                  ("2 layers, random", random_rnn(SimpleGRU)))
    rnn_errs = {"gru": [], "gru_simt": [], "lstm": [], "lstm_simt": []}
    lstm_models = (("1 layer, pretrained", lstm_pretrained),
                   ("2 layers, random", random_rnn(SimpleLSTM)))
    for rnn, rnn_cls, models in (
            ("gru", GRUClassifier, gru_models),
            ("gru_simt", lambda m, dt: GRUClassifier(m, dt, _simt=True),
             gru_models),
            ("lstm", LSTMClassifier, lstm_models),
            ("lstm_simt", lambda m, dt: LSTMClassifier(m, dt, _simt=True),
             lstm_models)):
        for label, model in models:
            for dtype in (torch.float32, torch.bfloat16):
                x = feats.to(dtype)
                got = rnn_cls(model, dtype)(x)
                torch.cuda.synchronize()
                with torch.inference_mode():
                    want = model(x.float(), dtype)
                what = f"{rnn} {label} {str(dtype)[6:]}"
                if dtype == torch.float32:
                    rnn_errs[rnn].append(
                        check_close(what, got, want, GRU_ATOL, GRU_RTOL))
                else:
                    check_close(what, got, want, GRU_BF16_ATOL, 0.0)

    cnn_models = {m: load_native(path, dev).model
                  for m, path in CNN_CHECKPOINTS.items()}
    delta_feats = Frontend(ListenerParams(use_delta=True), "mfcc", dev)(audio_f32)
    odd_feats = torch.tensor(
        4.0 * np.random.default_rng(3).standard_normal((B_CHECK, 29, 21)),
        dtype=torch.float32, device=dev)
    cnn_cases = [
        ("simple_cnn pretrained", cnn_models["simple_cnn"], feats),
        ("simple_cnn_lite pretrained", cnn_models["simple_cnn_lite"], feats),
        ("simple_cnn_lite random 30x40", random_cnn(SimpleCNNLite, 30, 40, 4, dev),
         delta_feats),
        ("simple_cnn random 29x21", random_cnn(SimpleCNN, 29, 21, 5, dev),
         odd_feats),
    ]
    # the tiled implicit GEMM (what CNNClassifier launches) and the SIMT
    # kernel kept for the A/B, each held to the plain version
    cnn_errs = {"cnn_classifier": [], "cnn_classifier_simt": []}
    for label, model, x in cnn_cases:
        for dtype in (torch.float32, torch.bfloat16):
            cls = CNNClassifier(model, dtype)
            xin = x.to(dtype)
            want = cnn_kernel.cnn_classifier_plain(cls.consts, xin)
            for name, simt in (("cnn_classifier", False),
                               ("cnn_classifier_simt", True)):
                got = cnn_kernel.cnn_classifier_cuda(xin, cls.consts, _simt=simt)
                torch.cuda.synchronize()
                what = f"{name} {label} {str(dtype)[6:]}"
                if dtype == torch.float32:
                    cnn_errs[name].append(check_close(what, got, want,
                                                      CNN_ATOL, CNN_RTOL))
                else:
                    check_close(what, got, want, CNN_BF16_ATOL, 0.0)
    # the block-1 kernel (what make_fused_cnn_forward launches) and the SIMT
    # kernel kept for the A/B, each held to the plain version, on f32 and
    # bf16 features
    block1_errs = {"cnn_block1": [], "cnn_block1_simt": []}
    for name, model in cnn_models.items():
        for dtype in (torch.float32, torch.bfloat16):
            stage = cnn_kernel.StageTensors(
                lower_block1(model.variables(), model.separable, 30, 20), dev,
                dtype)
            for x in (feats, feats.to(torch.bfloat16)):
                want = cnn_kernel.cnn_block1_plain(stage, x)
                for kname, simt in (("cnn_block1", False),
                                    ("cnn_block1_simt", True)):
                    got = cnn_kernel.cnn_block1_cuda(x, stage, _simt=simt)
                    torch.cuda.synchronize()
                    what = (f"{kname} {name} {str(dtype)[6:]} on "
                            f"{str(x.dtype)[6:]} features")
                    if dtype == torch.float32:
                        block1_errs[kname].append(check_close(
                            what, got, want, BLOCK1_ATOL, BLOCK1_RTOL))
                    else:
                        check_close(what, got, want, BLOCK1_BF16_ATOL, 0.0)
        got = make_fused_cnn_forward(model)(feats)
        torch.cuda.synchronize()
        with torch.inference_mode():
            want = model(feats)
        check_close(f"fused-block-1 forward {name} vs model f32", got, want,
                    CNN_ATOL, CNN_RTOL)

    # the f32 dense-DFT frontends (K6 :76 and :188) and the load floor (K7)
    dense_cases = (
        ("dense_dft_combined", "default", {}),
        ("dense_dft_combined", "window_t=0.05 (W 800)", {"window_t": 0.05}),
        ("dense_dft_halves", "default", {}),
        ("dense_dft_halves", "window_t=0.05, hop_t=0.025 (W = 2 hop = 800)",
         {"window_t": 0.05, "hop_t": 0.025}),
    )
    dense_errs = {"dense_dft_combined": [], "dense_dft_halves": []}
    for name, label, kw in dense_cases:
        consts = dense_dft_kernel.DenseDftConstants(ListenerParams(**kw), dev)
        got = getattr(dense_dft_kernel, name + "_cuda")(audio_f32, consts)
        torch.cuda.synchronize()
        want = getattr(dense_dft_kernel, name + "_plain")(audio_f32, consts)
        dense_errs[name].append(check_close(f"{name} {label}", got, want,
                                            FEAT_ATOL, FEAT_RTOL))
    out_cols = ListenerParams().n_features * ListenerParams().n_mfcc
    load_errs = {"load_rowsum": [], "load_broadcast": []}
    for gain in (1.0, 1.5):
        for name, extra in (("load_rowsum", ()), ("load_broadcast", (out_cols,))):
            got = getattr(load_kernel, name + "_cuda")(audio_f32, gain, *extra)
            torch.cuda.synchronize()
            want = getattr(load_kernel, name + "_plain")(audio_f32, gain, *extra)
            load_errs[name].append(check_rowsum(f"{name} gain {gain}", got,
                                                want, audio_f32, gain))

    # the FFT kernel at a window longer than n_fft (it reads the first n_fft
    # samples of a frame), at alt_512 and an odd hop, at every n_fft of its
    # register body and at one of its radix-2 body, in both input and output
    # types; its radix-2 body at the default config
    radix2_errs = []
    fft_cases = [
        ("window 1200 > n_fft 1024", {"window_t": 0.075}),
        ("alt_512", {"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                     "n_filt": 26, "n_mfcc": 13}),
        ("odd hop 481", {"hop_t": 481 / 16000}),
        *((f"n_fft {n}", {"n_fft": n, "window_t": min(0.064, n / 16000)})
          for n in (128, 256, 512, 2048, 4096, 8192)),
    ]
    for name, kw in fft_cases:
        p = ListenerParams(**kw)
        body = frontend_kernel.fft_body(p)
        for audio, out_dtype, gain in ((audio_f32, torch.float32, 0.8),
                                       (audio_i16, torch.bfloat16, 1.25),
                                       (audio_i16, torch.float32, 1.0),
                                       (audio_f32, torch.bfloat16, 1.1)):
            fe = MfccFrontend(p, "mfcc", dev, out_dtype=out_dtype)
            got = fe(audio, gain)
            torch.cuda.synchronize()
            want = fe.plain(audio, gain).to(out_dtype)
            what = (f"frontend ({body}) {name} mfcc {str(audio.dtype)[6:]}->"
                    f"{str(out_dtype)[6:]} gain {gain}")
            if out_dtype == torch.float32:
                (radix2_errs if body == "radix2" else frontend_errs).append(
                    check_close(what, got, want, FEAT_ATOL, FEAT_RTOL))
            else:
                check_close(what, got, want, FEAT_BF16_ATOL, FEAT_BF16_RTOL)
    p = ListenerParams()
    fe_consts = frontend_kernel.KernelConstants(p, "mfcc", dev)
    for audio, out_dtype, gain in ((audio_f32, torch.float32, 0.8),
                                   (audio_i16, torch.bfloat16, 1.25)):
        gain_t = torch.full((1,), gain, dtype=torch.float32, device=dev)
        got = frontend_kernel.mfcc_frontend_cuda(audio, gain_t, fe_consts, p,
                                                 out_dtype, _radix2=True)
        torch.cuda.synchronize()
        want = Frontend(p, "mfcc", dev)(audio, gain).to(out_dtype)
        what = (f"frontend (radix2 forced) default mfcc "
                f"{str(audio.dtype)[6:]}->{str(out_dtype)[6:]} gain {gain}")
        if out_dtype == torch.float32:
            radix2_errs.append(check_close(what, got, want, FEAT_ATOL,
                                           FEAT_RTOL))
        else:
            check_close(what, got, want, FEAT_BF16_ATOL, FEAT_BF16_RTOL)
    # the dense combined kernel with a gain and a first frame (the JAX
    # dense frontend's f32 contract)
    consts = dense_dft_kernel.DenseDftConstants(ListenerParams(hop_t=0.03), dev)
    gain_t = torch.full((1,), 1.3, dtype=torch.float32, device=dev)
    dense_errs["dense_dft_combined"].append(check_close(
        "dense_dft_combined hop_t=0.03 gain 1.3 first_frame 1",
        dense_dft_kernel.dense_dft_combined_cuda(audio_f32, consts, gain_t, 1),
        dense_dft_kernel.dense_dft_combined_plain(audio_f32, consts, gain_t, 1),
        FEAT_ATOL, FEAT_RTOL))
    # the CT split kernel, every instantiation (forced: route ct takes the
    # mixed-radix FFT at n_fft 768)
    ct_errs = {name: [] for name in ct_kernel.VARIANTS}
    ct_cases = (
        ("default", {}, audio_f32, torch.float32, 0.8, (False, True)),
        ("n_fft=window=768 use_delta", {"n_fft": 768, "window_t": 0.048,
                                        "use_delta": True},
         audio_i16, torch.bfloat16, 1.25, (False,)),
    )
    for label, kw, audio, out_dtype, gain, layouts in ct_cases:
        p = ListenerParams(**kw)
        consts = ct_kernel.CtConstants(p, "mfcc", dev)
        gain_t = torch.full((1,), gain, dtype=torch.float32, device=dev)
        for name, (paired, per_piece, _) in ct_kernel.VARIANTS.items():
            for time_major in layouts:
                got = ct_kernel.ct_frontend_cuda(audio, gain_t, consts, p,
                                                 paired, per_piece, time_major,
                                                 out_dtype, _split=True)
                torch.cuda.synchronize()
                want = ct_kernel.ct_frontend_plain(audio, gain, consts, p,
                                                   paired, per_piece,
                                                   time_major, out_dtype)
                what = (f"{name} {label} {'time' if time_major else 'batch'}"
                        f"-major {str(audio.dtype)[6:]}->{str(out_dtype)[6:]}")
                if out_dtype == torch.float32:
                    ct_errs[name].append(check_close(what, got, want,
                                                     FEAT_ATOL, FEAT_RTOL))
                else:
                    check_close(what, got, want, FEAT_BF16_ATOL, FEAT_BF16_RTOL)
    # route ct's mixed-radix FFT at every n_fft it takes, in both input and
    # output types, batch- and time-major, with and without deltas, held to
    # the CT plain version
    mixed_errs = []
    mixed_cases = ((audio_f32, torch.float32, 0.8, False, False),
                   (audio_i16, torch.bfloat16, 1.25, True, True),
                   (audio_i16, torch.float32, 1.0, False, True),
                   (audio_f32, torch.bfloat16, 1.1, True, False))
    for n_fft in sorted(fft_plan.MIXED_PLANS):
        for audio, out_dtype, gain, time_major, delta in mixed_cases:
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000,
                               use_delta=delta)
            consts = ct_kernel.CtConstants(p, "mfcc", dev)
            gain_t = torch.full((1,), gain, dtype=torch.float32, device=dev)
            got = ct_kernel.ct_frontend_cuda(audio, gain_t, consts, p,
                                             time_major=time_major,
                                             out_dtype=out_dtype)
            torch.cuda.synchronize()
            want = ct_kernel.ct_frontend_plain(audio, gain, consts, p,
                                               time_major=time_major,
                                               out_dtype=out_dtype)
            what = (f"mixed_fft_frontend n_fft {n_fft} "
                    f"{'time' if time_major else 'batch'}-major"
                    f"{' deltas' if delta else ''} {str(audio.dtype)[6:]}->"
                    f"{str(out_dtype)[6:]} ({consts.layout.warps} warps)")
            if out_dtype == torch.float32:
                mixed_errs.append(check_close(what, got, want, FEAT_ATOL,
                                              FEAT_RTOL))
            else:
                check_close(what, got, want, FEAT_BF16_ATOL, FEAT_BF16_RTOL)
    # route ct above n_fft 4096: the CT split's (F, T) instantiation
    # ("split-dup"), chosen from the config, at both ends of its sizes and
    # one between, in the mixed FFT's four cases, held to the CT plain
    # version (its per-piece-mel form)
    for n_fft in SPLIT_DUP:
        for audio, out_dtype, gain, time_major, delta in mixed_cases:
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000,
                               use_delta=delta)
            consts = ct_kernel.CtConstants(p, "mfcc", dev)
            if consts.body != "split-dup":
                raise AssertionError(f"n_fft {n_fft}: route ct's body is "
                                     f"{consts.body}, not split-dup")
            gain_t = torch.full((1,), gain, dtype=torch.float32, device=dev)
            got = ct_kernel.ct_frontend_cuda(audio, gain_t, consts, p,
                                             time_major=time_major,
                                             out_dtype=out_dtype)
            torch.cuda.synchronize()
            want = ct_kernel.ct_frontend_plain(audio, gain, consts, p,
                                               per_piece_mel=True,
                                               time_major=time_major,
                                               out_dtype=out_dtype)
            what = (f"ct_frontend_dup (split-dup) n_fft {n_fft} "
                    f"{'time' if time_major else 'batch'}-major"
                    f"{' deltas' if delta else ''} {str(audio.dtype)[6:]}->"
                    f"{str(out_dtype)[6:]}")
            if out_dtype == torch.float32:
                ct_errs["ct_frontend_dup"].append(check_close(
                    what, got, want, FEAT_ATOL, FEAT_RTOL))
            else:
                check_close(what, got, want, FEAT_BF16_ATOL, FEAT_BF16_RTOL)
    # the stage cuts of both frontend kernels (K8 r3_omission :164), each
    # held to the one plain version with its stage's bound
    cut_consts = omission_kernel.TruncatedConstants(ListenerParams(), dev)
    cut_errs = {name: [] for name in omission_kernel.counters}

    def check_cut(kernel, stage, audio, gain, constant_block, label):
        p = ListenerParams()
        gain_t = torch.full((1,), gain, dtype=torch.float32, device=dev)
        got = omission_kernel.truncated(audio, gain_t, cut_consts, p, stage,
                                        kernel, constant_block)
        torch.cuda.synchronize()
        want = omission_kernel.truncated_plain(audio, gain, p, stage,
                                               constant_block, cut_consts.ct)
        name = omission_kernel.counter_name(kernel, stage)
        mode = "constant-block" if constant_block else "streamed"
        cut_errs[name].append(check_close(f"{name} {mode} {label}", got, want,
                                          *r3_omission.TOLERANCES[stage]))

    cut_np = test_audio(clips, B_CUT, seed=4)
    cut_f32 = torch.tensor(cut_np, device=dev)
    cut_i16 = torch.tensor(
        np.clip(np.round(cut_np * 32768.0), -32768, 32767).astype(np.int16),
        device=dev)
    for kernel, stages in omission_kernel.KERNELS.items():
        for stage in stages:
            for constant_block in (False, True):
                check_cut(kernel, stage, cut_f32, 1.3, constant_block,
                          f"B = {B_CUT} float32 gain 1.3")
        for constant_block in (False, True):
            check_cut(kernel, "full", cut_i16, 0.8, constant_block,
                      f"B = {B_CUT} int16 gain 0.8")

    # -- 4. the slices ---------------------------------------------------------
    counters = {
        "mfcc_frontend": frontend_kernel.mfcc_frontend_cuda,
        "mfcc_frontend_radix2": frontend_kernel.RADIX2,
        "dft_frontend_bf16": frontend_kernel.dft_frontend_bf16_cuda,
        "dft_frontend_mma_sync": frontend_kernel.MMA_SYNC,
        "gru_classifier": rnn_kernel.gru_layer_cuda,
        "gru_classifier_simt": rnn_kernel.GRU_SIMT,
        "lstm_classifier": rnn_kernel.lstm_layer_cuda,
        "lstm_classifier_simt": rnn_kernel.LSTM_SIMT,
        "cnn_classifier": cnn_kernel.cnn_classifier_cuda,
        "cnn_classifier_simt": cnn_kernel.SIMT,
        "cnn_block1": cnn_kernel.cnn_block1_cuda,
        "cnn_block1_simt": cnn_kernel.BLOCK1_SIMT,
        "dense_dft_combined": dense_dft_kernel.dense_dft_combined_cuda,
        "dense_dft_halves": dense_dft_kernel.dense_dft_halves_cuda,
        "load_rowsum": load_kernel.load_rowsum_cuda,
        "load_broadcast": load_kernel.load_broadcast_cuda,
        "mixed_fft_frontend": ct_kernel.MIXED,
        **ct_kernel.counters,
        **omission_kernel.counters,
    }
    launches = dict.fromkeys(counters, 0)

    def drive(label, run, need, forbid=()):
        """Run one path with every launch count at 0; fail unless each
        kernel in `need` was launched and none in `forbid` was; add the
        counts to `launches`."""
        for fn in counters.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        log(f"slice: {label}, launches {counts}")
        for name in need:
            if counts[name] < 1:
                raise AssertionError(f"{name} kernel was not launched by {label}")
        for name in forbid:
            if counts[name]:
                raise AssertionError(f"{name} kernel was launched by {label}")
        for name, count in counts.items():
            launches[name] += count
        return out

    clips_dev = torch.tensor(clips, device=dev)
    scorer_paths = (
        (CHECKPOINT, "cuda-gru", "gru_classifier", ("gru_classifier_simt",)),
        (LSTM_CHECKPOINT, "cuda-lstm", "lstm_classifier",
         ("lstm_classifier_simt",)),
        (CNN_CHECKPOINTS["simple_cnn"], "cuda-cnn", "cnn_classifier", ()),
        (CNN_CHECKPOINTS["simple_cnn_lite"], "cuda-cnn", "cnn_classifier", ()),
    )
    scorers_by_path = {}
    for path, classifier_path, kernel_name, forbid in scorer_paths:
        scorers = {dt: make_batch_scorer(path, "cuda", dt)
                   for dt in (torch.float32, torch.bfloat16)}
        scorers_by_path[path] = scorers
        scores = drive(
            f"make_batch_scorer({os.path.relpath(path, REPO)}) on 8 clips, "
            "f32 and bf16",
            lambda: {dt: s(clips_dev) for dt, s in scorers.items()},
            ("mfcc_frontend", kernel_name), forbid)
        for dt, s in scorers.items():
            if s.paths["frontend"].split("(")[0] != "cuda-mfcc" or \
                    s.paths["classifier"] != classifier_path:
                raise AssertionError(f"paths {s.paths} do not name both kernels")
            sc = scores[dt]
            if sc.shape != (8, s.num_classes) or not torch.isfinite(sc).all():
                raise AssertionError(f"scores {tuple(sc.shape)} not finite (8, C)")
            top1 = [s.classes[i] for i in sc.argmax(-1).tolist()]
            n_ok = sum(a == b for a, b in zip(top1, labels))
            log(f"  {str(dt)[6:]:8s} paths {s.paths}  top-1 {n_ok}/8 {top1}")
            if top1 != labels:
                raise AssertionError(f"top-1 {top1} != labels {labels}")
            cpu = make_batch_scorer(path, "cpu", dt)(clips)
            atol = SCORE_ATOL if dt == torch.float32 else SCORE_BF16_ATOL
            check_close(f"scores card vs CPU {str(dt)[6:]}", sc.cpu(), cpu,
                        atol, 0.0)

    # the frontend routes: a config of each class, on the GRU checkpoint
    route_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(route_dir, exist_ok=True)
    route_cases = (
        ("n_fft = window = 768", CT_ROUTE, "cuda-ct",
         ("mixed_fft_frontend", "gru_classifier"), tuple(ct_kernel.counters)),
        ("window 1200 > n_fft 1024", {"window_t": 0.075}, "cuda-mfcc",
         ("mfcc_frontend", "gru_classifier"), ()),
        ("n_fft 8192 (the radix-2 body)", {"n_fft": 8192}, "cuda-mfcc",
         ("mfcc_frontend_radix2", "gru_classifier"), ()),
        ("n_fft 400", {"n_fft": 400, "window_t": 0.025}, "torch(xla-route)",
         ("gru_classifier",), ()),
        ("n_fft = window = 4352 (route ct's split-dup body)", SPLIT_DUP_ROUTE,
         "cuda-ct(split-dup)", ("ct_frontend_dup", "gru_classifier"),
         ("mixed_fft_frontend", "ct_frontend", "ct_frontend_paired",
          "ct_frontend_ppmel")),
    )
    for label, overrides, route, need, forbid in route_cases:
        path = with_params(CHECKPOINT, overrides, route_dir)
        scorer = make_batch_scorer(path, "cuda")
        sc = drive(f"make_batch_scorer(direction_simple_gru.npz, {label}) on "
                   "8 clips", lambda: scorer(clips_dev), need, forbid)
        log(f"  paths {scorer.paths}")
        if scorer.paths["frontend"] != route:
            raise AssertionError(f"{label}: frontend {scorer.paths['frontend']}"
                                 f" is not {route}")
        if sc.shape != (8, scorer.num_classes) or not torch.isfinite(sc).all():
            raise AssertionError(f"scores {tuple(sc.shape)} not finite (8, C)")
        check_close(f"scores card vs CPU, {label}", sc.cpu(),
                    make_batch_scorer(path, "cpu")(clips), SCORE_ATOL, 0.0)

    for name, path in CNN_CHECKPOINTS.items():
        predictor = load_native(path, dev)
        fe = MfccFrontend(None, predictor.meta.get("feature_type", "mfcc"), dev)
        forwards = {dt: make_fused_cnn_forward(predictor.model, dt)
                    for dt in (torch.float32, torch.bfloat16)}
        scores = drive(
            f"frontend kernel + make_fused_cnn_forward({name}) on 8 clips, "
            "f32 and bf16",
            lambda: {dt: score_fn(f(fe(clips_dev))) for dt, f in forwards.items()},
            ("mfcc_frontend", "cnn_block1"), ("cnn_block1_simt",))
        for dt, sc in scores.items():
            top1 = [predictor.classes[i] for i in sc.argmax(-1).tolist()]
            log(f"  {str(dt)[6:]:8s} top-1 {sum(a == b for a, b in zip(top1, labels))}/8")
            if not torch.isfinite(sc).all() or top1 != labels:
                raise AssertionError(f"top-1 {top1} != labels {labels}")

    # the SIMT block-1 kernel kept for the A/B, behind the frontend kernel,
    # then the model's blocks 2-4
    for name, path in CNN_CHECKPOINTS.items():
        predictor = load_native(path, dev)
        fe = MfccFrontend(None, predictor.meta.get("feature_type", "mfcc"), dev)
        model = predictor.model
        stages = {dt: cnn_kernel.StageTensors(
            lower_block1(model.variables(), model.separable, model.n_features,
                         model.feature_size), dev, dt)
            for dt in (torch.float32, torch.bfloat16)}

        def simt_forward(dt):
            with torch.inference_mode():
                return model(cnn_kernel.cnn_block1_cuda(
                    fe(clips_dev), stages[dt], _simt=True), skip_block1=True)

        scores = drive(
            f"frontend kernel + cnn_block1_cuda({name}, _simt=True) + blocks "
            "2-4 on 8 clips, f32 and bf16",
            lambda: {dt: score_fn(simt_forward(dt)) for dt in stages},
            ("mfcc_frontend", "cnn_block1_simt"), ("cnn_block1",))
        for dt, sc in scores.items():
            top1 = [predictor.classes[i] for i in sc.argmax(-1).tolist()]
            log(f"  {str(dt)[6:]:8s} top-1 {sum(a == b for a, b in zip(top1, labels))}/8")
            if not torch.isfinite(sc).all() or top1 != labels:
                raise AssertionError(f"top-1 {top1} != labels {labels}")

    # the SIMT classifiers kept for the A/B, behind the frontend kernel
    for path, cls, name in ((CHECKPOINT, GRUClassifier, "gru_classifier"),
                            (LSTM_CHECKPOINT, LSTMClassifier,
                             "lstm_classifier")):
        predictor = load_native(path, dev)
        fe = MfccFrontend(None, predictor.meta.get("feature_type", "mfcc"), dev)
        simt = {dt: cls(predictor.model, dt, _simt=True)
                for dt in (torch.float32, torch.bfloat16)}
        scores = drive(
            f"frontend kernel + {cls.__name__}({os.path.basename(path)}, "
            "_simt=True) on 8 clips, f32 and bf16",
            lambda: {dt: score_fn(c(fe(clips_dev).to(dt)))
                     for dt, c in simt.items()},
            ("mfcc_frontend", name + "_simt"), (name,))
        for dt, sc in scores.items():
            top1 = [predictor.classes[i] for i in sc.argmax(-1).tolist()]
            log(f"  {str(dt)[6:]:8s} top-1 {sum(a == b for a, b in zip(top1, labels))}/8")
            if not torch.isfinite(sc).all() or top1 != labels:
                raise AssertionError(f"top-1 {top1} != labels {labels}")
    for name, path in CNN_CHECKPOINTS.items():
        predictor = load_native(path, dev)
        fe = MfccFrontend(None, predictor.meta.get("feature_type", "mfcc"), dev)
        consts = {dt: CNNClassifier(predictor.model, dt).consts
                  for dt in (torch.float32, torch.bfloat16)}
        scores = drive(
            f"frontend kernel + cnn_classifier_cuda({name}, _simt=True) on 8 "
            "clips, f32 and bf16",
            lambda: {dt: score_fn(cnn_kernel.cnn_classifier_cuda(
                fe(clips_dev).to(dt), c, _simt=True)) for dt, c in consts.items()},
            ("mfcc_frontend", "cnn_classifier_simt"))
        for dt, sc in scores.items():
            top1 = [predictor.classes[i] for i in sc.argmax(-1).tolist()]
            log(f"  {str(dt)[6:]:8s} top-1 {sum(a == b for a, b in zip(top1, labels))}/8")
            if not torch.isfinite(sc).all() or top1 != labels:
                raise AssertionError(f"top-1 {top1} != labels {labels}")

    fast_paths = (
        (CHECKPOINT, GRUClassifier, "gru_classifier"),
        (LSTM_CHECKPOINT, LSTMClassifier, "lstm_classifier"),
        (CNN_CHECKPOINTS["simple_cnn"], CNNClassifier, "cnn_classifier"),
        (CNN_CHECKPOINTS["simple_cnn_lite"], CNNClassifier, "cnn_classifier"),
    )
    for path, cls, kernel_name in fast_paths:
        predictor = load_native(path, dev)
        fe = MfccFrontend(None, predictor.meta.get("feature_type", "mfcc"), dev,
                          fast_math=True)
        classifiers = {dt: cls(predictor.model, dt)
                       for dt in (torch.float32, torch.bfloat16)}
        scores = drive(
            f"MfccFrontend(fast_math=True) + {cls.__name__}("
            f"{os.path.basename(path)}) on 8 clips, f32 and bf16",
            lambda: {dt: score_fn(c(fe(clips_dev)))
                     for dt, c in classifiers.items()},
            ("dft_frontend_bf16", kernel_name), ("dft_frontend_mma_sync",))
        for dt, sc in scores.items():
            top1 = [predictor.classes[i] for i in sc.argmax(-1).tolist()]
            log(f"  {str(dt)[6:]:8s} top-1 {sum(a == b for a, b in zip(top1, labels))}/8")
            if not torch.isfinite(sc).all() or top1 != labels:
                raise AssertionError(f"top-1 {top1} != labels {labels}")

    # the first fast_math design kept for the A/B (`_mma_sync=True`) into
    # the GRU classifier kernel
    predictor = load_native(CHECKPOINT, dev)
    fe = MfccFrontend(None, "mfcc", dev, fast_math=True)
    classifiers = {dt: GRUClassifier(predictor.model, dt)
                   for dt in (torch.float32, torch.bfloat16)}
    scores = drive(
        "fast_math constants + dft_frontend_bf16_cuda(_mma_sync=True) + "
        "GRUClassifier(direction_simple_gru.npz) on 8 clips, f32 and bf16",
        lambda: {dt: score_fn(c(frontend_kernel.dft_frontend_bf16_cuda(
            clips_dev, fe._unit_gain, fe.consts, fe.params, _mma_sync=True)))
            for dt, c in classifiers.items()},
        ("dft_frontend_mma_sync", "gru_classifier"), ("dft_frontend_bf16",))
    for dt, sc in scores.items():
        top1 = [predictor.classes[i] for i in sc.argmax(-1).tolist()]
        log(f"  {str(dt)[6:]:8s} top-1 {sum(a == b for a, b in zip(top1, labels))}/8")
        if not torch.isfinite(sc).all() or top1 != labels:
            raise AssertionError(f"top-1 {top1} != labels {labels}")

    # the measurement entry points, at their own batch, a few iterations each
    drive("dev.pallas_experiments.main(): every variant, B = 16384",
          lambda: pallas_experiments.main(["--iters", "2", "--repeats", "1"]),
          ("dense_dft_combined", "dense_dft_halves", "dft_frontend_bf16",
           "mfcc_frontend"))
    drive("dev.r3_experiments.main(): load and frontend_tile, B = 8192",
          lambda: r3_experiments.main(["--iters", "4", "--outer", "1"]),
          ("load_rowsum", "mfcc_frontend"))
    drive("dev.r4_mxu_stage1.main(): ct, dense and load, B = 8192",
          lambda: r4_mxu_stage1.main(["--iters", "4"]),
          ("mfcc_frontend", "dense_dft_combined", "load_broadcast"))
    drive("dev.r3_frontend_variants.main(): mel concat and dup, B = 8192",
          lambda: r3_frontend_variants.main(["--iters", "4"]),
          ("mfcc_frontend", "ct_frontend", "ct_frontend_dup"))
    drive("dev.r3_stage2.main(): perres, paired and ppmel, B = 8192",
          lambda: r3_stage2.main(["--iters", "4"]),
          ("mfcc_frontend", "ct_frontend", "ct_frontend_paired",
           "ct_frontend_ppmel"))
    drive("dev.r3_widecell.main(): B = 8192",
          lambda: r3_widecell.main(["--iters", "4"]),
          ("mfcc_frontend", "ct_frontend"))
    drive("dev.r3_omission.main(): every stage cut of both kernels, B = 8192",
          lambda: r3_omission.main(["--iters", "2", "--outer", "1"]),
          tuple(omission_kernel.counters))

    # -- 5. times (information only) -------------------------------------------
    log(f"times at B = {B_TIME}, audio resident on the card ({card}):")
    big_np = test_audio(clips, B_TIME, seed=2)
    big = torch.tensor(big_np, device=dev)
    fe = MfccFrontend(ListenerParams(), "mfcc", dev)
    big_feats = fe(big)
    cnn = cnn_models["simple_cnn"]
    cnn_cls = CNNClassifier(cnn, torch.float32)
    stage = cnn_kernel.StageTensors(lower_block1(cnn.variables(), False, 30, 20),
                                    dev)
    fast_fe = MfccFrontend(ListenerParams(), "mfcc", dev, fast_math=True)
    p0 = ListenerParams()
    unit_gain = torch.ones(1, dtype=torch.float32, device=dev)

    def radix2(x=big):
        return frontend_kernel.mfcc_frontend_cuda(x, unit_gain, fe.consts, p0,
                                                  _radix2=True)

    # both bodies held to the plain version at this batch, then in turns
    fe_plain_big = fe.plain(big)
    frontend_errs.append(check_close(f"frontend (register) default B = "
                                     f"{B_TIME}", fe(big), fe_plain_big,
                                     FEAT_ATOL, FEAT_RTOL))
    radix2_errs.append(check_close(f"frontend (radix2 forced) default B = "
                                   f"{B_TIME}", radix2(), fe_plain_big,
                                   FEAT_ATOL, FEAT_RTOL))
    del fe_plain_big
    body_ab = {"radix2": [], "register": []}
    for which in ("radix2", "register", "register", "radix2"):
        body_ab[which].append(cuda_ms(radix2 if which == "radix2" else
                                      (lambda: fe(big)), 20))
    log(f"  A/B at B = {B_TIME}, default config, f32 audio and output, in "
        f"turns radix-2, register, register, radix-2: register body "
        f"(mfcc_frontend) {body_ab['register'][0]:.4f}, "
        f"{body_ab['register'][1]:.4f} ms; radix-2 body "
        f"(mfcc_frontend_radix2) {body_ab['radix2'][0]:.4f}, "
        f"{body_ab['radix2'][1]:.4f} ms = "
        f"{sum(body_ab['radix2']) / sum(body_ab['register']):.2f}x  ({card})")
    fe_plain_ms = cuda_ms(lambda: fe.plain(big), 5)  # both bodies' function
    # the fast_math kernels: the wgmma one against the first design in
    # turns, mma_sync, wgmma, wgmma, mma_sync, both first held to the plain
    # version at this batch; beside them the bound, the plain version and,
    # as a yardstick only (the port never calls it), the DFT product alone
    # through cuBLAS: torch.matmul of the bf16 frames and the bf16 matrix
    def mma_sync(x=big):
        return frontend_kernel.dft_frontend_bf16_cuda(
            x, unit_gain, fast_fe.consts, p0, _mma_sync=True)

    fast_plain = fast_fe.plain(big)
    fast_errs.append(check_close(f"fast_math default B = {B_TIME}",
                                 fast_fe(big), fast_plain, FEAT_ATOL,
                                 FEAT_RTOL))
    mma_sync_errs.append(check_close(f"fast_math (mma_sync) default B = "
                                     f"{B_TIME}", mma_sync(), fast_plain,
                                     FEAT_ATOL, FEAT_RTOL))
    del fast_plain
    fast_ab = {"mma_sync": [], "wgmma": []}
    for which in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        fast_ab[which].append(cuda_ms(mma_sync if which == "mma_sync" else
                                      (lambda: fast_fe(big)), 20))
    frames = frame_signal(big, p0.window_samples, p0.hop_samples)[
        :, -p0.n_features:].reshape(-1, p0.window_samples).to(torch.bfloat16)
    dft_t = fast_fe.consts.dft[:, :p0.window_samples].t()
    cublas_ms = cuda_ms(lambda: torch.matmul(frames, dft_t), 20)
    del frames
    fast_plain_ms = cuda_ms(lambda: fast_fe.plain(big), 5)
    log(f"  fast_math A/B at B = {B_TIME}, default config, f32 audio and "
        f"output, in turns mma_sync, wgmma, wgmma, mma_sync: wgmma "
        f"(dft_frontend_bf16) {fast_ab['wgmma'][0]:.4f}, "
        f"{fast_ab['wgmma'][1]:.4f} ms; mma_sync (dft_frontend_mma_sync) "
        f"{fast_ab['mma_sync'][0]:.4f}, {fast_ab['mma_sync'][1]:.4f} ms = "
        f"{sum(fast_ab['mma_sync']) / sum(fast_ab['wgmma']):.2f}x; bound "
        f"{dft_bound(p0, B_TIME)[0]:.4f} ms ({dft_bound(p0, B_TIME)[1]}); "
        f"plain {fast_plain_ms:.4f} "
        f"ms; the DFT product alone through cuBLAS (torch.matmul, bf16 "
        f"(245,760 x 1024) @ (1024 x 1040), a yardstick) {cublas_ms:.4f} ms  "
        f"({card})")
    # route ct's split-dup body at n_fft 4352: held to the CT plain version
    # at this batch, timed beside its bound and the plain version
    p_dup = ListenerParams(**SPLIT_DUP_ROUTE)
    dup_consts = ct_kernel.CtConstants(p_dup, "mfcc", dev)
    dup_want = ct_kernel.ct_frontend_plain(big, None, dup_consts, p_dup,
                                           per_piece_mel=True)
    ct_errs["ct_frontend_dup"].append(check_close(
        f"ct_frontend_dup (split-dup) n_fft 4352 B = {B_TIME}",
        ct_kernel.ct_frontend_cuda(big, unit_gain, dup_consts, p_dup),
        dup_want, FEAT_ATOL, FEAT_RTOL))
    del dup_want
    dup_ms = cuda_ms(lambda: ct_kernel.ct_frontend_cuda(big, unit_gain,
                                                        dup_consts, p_dup), 5)
    dup_plain_ms = cuda_ms(lambda: ct_kernel.ct_frontend_plain(
        big, None, dup_consts, p_dup, per_piece_mel=True), 2)
    dup_bound = frontend_bound(p_dup, B_TIME)
    log(f"  route ct's split-dup body (ct_frontend_dup) at n_fft = window = "
        f"4352 ({p_dup.n_features} frames), B = {B_TIME}, f32 audio and "
        f"output: {dup_ms:.4f} ms; CT plain {dup_plain_ms:.4f} ms; bound "
        f"{dup_bound[0]:.4f} ms ({dup_bound[1]})  ({card})")
    times = {
        "mfcc_frontend": (cuda_ms(lambda: fe(big), 20), fe_plain_ms),
        "mfcc_frontend_radix2": (cuda_ms(radix2, 10), fe_plain_ms),
        "dft_frontend_bf16": (fast_ab["wgmma"][0], fast_plain_ms),
        "dft_frontend_mma_sync": (fast_ab["mma_sync"][0], fast_plain_ms),
        "cnn_classifier": (
            cuda_ms(lambda: cnn_cls(big_feats), 20),
            cuda_ms(lambda: cnn_kernel.cnn_classifier_plain(cnn_cls.consts,
                                                            big_feats), 10)),
        "cnn_classifier_simt": (
            cuda_ms(lambda: cnn_kernel.cnn_classifier_cuda(
                big_feats, cnn_cls.consts, _simt=True), 20),
            cuda_ms(lambda: cnn_kernel.cnn_classifier_plain(cnn_cls.consts,
                                                            big_feats), 10)),
    }
    # the four measurement kernels are also held to their plain versions at
    # this batch, the one their entry points run (r3, r4: 8192)
    dense_consts = dense_dft_kernel.DenseDftConstants(ListenerParams(), dev)
    for name in ("dense_dft_combined", "dense_dft_halves"):
        launch = getattr(dense_dft_kernel, name + "_cuda")
        plain = getattr(dense_dft_kernel, name + "_plain")
        dense_errs[name].append(check_close(
            f"{name} default B = {B_TIME}", launch(big, dense_consts),
            plain(big, dense_consts), FEAT_ATOL, FEAT_RTOL))
        times[name] = (cuda_ms(lambda: launch(big, dense_consts), 10),
                       cuda_ms(lambda: plain(big, dense_consts), 5))
    for name, extra in (("load_rowsum", ()), ("load_broadcast", (out_cols,))):
        launch = getattr(load_kernel, name + "_cuda")
        plain = getattr(load_kernel, name + "_plain")
        for gain in (unit_gain, 1.5):
            load_errs[name].append(check_rowsum(
                f"{name} gain {float(gain)} B = {B_TIME}",
                launch(big, gain, *extra), plain(big, gain, *extra), big,
                gain))
        times[name] = (cuda_ms(lambda: launch(big, unit_gain, *extra), 50),
                       cuda_ms(lambda: plain(big, unit_gain, *extra), 20))
    # the CT split kernel's instantiations, held to the plain version at
    # this batch, and the (F, F) one against the FFT kernel in turns
    ct_consts = ct_kernel.CtConstants(p0, "mfcc", dev)
    for name, (paired, per_piece, _) in ct_kernel.VARIANTS.items():
        def ct_launch(paired=paired, per_piece=per_piece):
            return ct_kernel.ct_frontend_cuda(big, unit_gain, ct_consts, p0,
                                              paired, per_piece, _split=True)

        def ct_plain(paired=paired, per_piece=per_piece):
            return ct_kernel.ct_frontend_plain(big, None, ct_consts, p0,
                                               paired, per_piece)

        ct_errs[name].append(check_close(
            f"{name} default B = {B_TIME}", ct_launch(), ct_plain(),
            FEAT_ATOL, FEAT_RTOL))
        times[name] = (cuda_ms(ct_launch, 20), cuda_ms(ct_plain, 3))
    ab = {"fft": [], "ct_frontend": []}
    for which in ("fft", "ct_frontend", "ct_frontend", "fft"):
        ab[which].append(cuda_ms(
            (lambda: fe(big)) if which == "fft" else
            (lambda: ct_kernel.ct_frontend_cuda(big, unit_gain, ct_consts, p0,
                                                _split=True)),
            20))
    log(f"  A/B at B = {B_TIME}, default config, f32 audio and output, in "
        f"turns fft, ct, ct, fft: FFT kernel (mfcc_frontend) "
        f"{ab['fft'][0]:.4f}, {ab['fft'][1]:.4f} ms; CT kernel (ct_frontend, "
        f"(F, F)) {ab['ct_frontend'][0]:.4f}, {ab['ct_frontend'][1]:.4f} ms  "
        f"({card})")
    for name, (_, per_piece, _) in ct_kernel.VARIANTS.items():
        floor = ct_split_flops(p0, B_TIME, per_piece)
        log(f"  {name:18s} the CT split's own operations (an algorithm floor,"
            f" not the function's bound): {floor / 1e9:.2f} GFLOP = "
            f"{floor / PEAK_F32 * 1e3:.4f} ms at the f32 peak; kernel "
            f"{times[name][0]:.4f} ms = {floor / times[name][0] / 1e9:.2f} "
            f"TFLOP/s")
    # route ct's mixed-radix FFT against the CT split (F, F), in turns new,
    # split, split, new (the split refuses 2816), both first held to the
    # plain version at this batch, beside the bound and the plain version
    mixed_ab = {}
    for n_fft, hop_t in CT_AB:
        p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000, hop_t=hop_t)
        consts = ct_kernel.CtConstants(p, "mfcc", dev)
        runs = {"new": lambda: ct_kernel.ct_frontend_cuda(big, unit_gain,
                                                          consts, p)}
        if ct_kernel.split_fits(p):
            runs["split"] = lambda: ct_kernel.ct_frontend_cuda(
                big, unit_gain, consts, p, _split=True)
        want = ct_kernel.ct_frontend_plain(big, None, consts, p)
        for which, run in runs.items():
            name = "mixed_fft_frontend" if which == "new" else "ct_frontend"
            err = check_close(f"{name} n_fft {n_fft} hop_t {hop_t} B = "
                              f"{B_TIME}", run(), want, FEAT_ATOL, FEAT_RTOL)
            (mixed_errs if which == "new" else ct_errs[name]).append(err)
        del want
        ab = {which: [] for which in runs}
        for which in ("new", "split", "split", "new"):
            if which in runs:
                ab[which].append(cuda_ms(runs[which], 20))
        plain_ms = cuda_ms(lambda: ct_kernel.ct_frontend_plain(big, None,
                                                               consts, p), 3)
        bound = frontend_bound(p, B_TIME)
        mixed_ab[n_fft] = (ab, plain_ms, bound)
        split = (f"; CT split (ct_frontend, _split=True) {ab['split'][0]:.4f},"
                 f" {ab['split'][1]:.4f} ms = "
                 f"{sum(ab['split']) / sum(ab['new']):.2f}x"
                 if "split" in ab else "; the CT split refuses it")
        log(f"  route ct at n_fft = window = {n_fft}, hop_t {hop_t} "
            f"({p.n_features} frames), B = {B_TIME}, f32 audio and output, in "
            f"turns new, split, split, new: mixed-radix FFT "
            f"(mixed_fft_frontend, {consts.layout.warps} warps a block) "
            f"{ab['new'][0]:.4f}, {ab['new'][1]:.4f} ms{split}; plain "
            f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})  "
            f"({card})")
    ab, plain_ms, _ = mixed_ab[CT_ROUTE["n_fft"]]
    times["mixed_fft_frontend"] = (ab["new"][0], plain_ms)
    # the CNN block-1 kernel against its SIMT kernel in turns, simt, new,
    # new, simt, f32 and bf16 compute on f32 features, both first held to
    # the plain version at this batch; device times from CUDA graphs (the
    # new kernel is shorter than a call's host work).  Beside them the
    # bound, the plain version, F.conv2d alone through cuDNN (TF32 off: the
    # conv with no pool, bias or relu6, a yardstick for part of the
    # function, never called by the port) and make_fused_cnn_forward end to
    # end for simple_cnn, with the block-1 kernel's share of it
    import torch.nn.functional as F

    block1_ab = {}
    for dt in (torch.float32, torch.bfloat16):
        st = stage if dt == torch.float32 else cnn_kernel.StageTensors(
            lower_block1(cnn.variables(), False, 30, 20), dev, dt)
        want = cnn_kernel.cnn_block1_plain(st, big_feats)
        runs = {"new": lambda st=st: cnn_kernel.cnn_block1_cuda(big_feats, st),
                "simt": lambda st=st: cnn_kernel.cnn_block1_cuda(
                    big_feats, st, _simt=True)}
        for which, run in runs.items():
            kname = "cnn_block1" + ("_simt" if which == "simt" else "")
            what = f"{kname} simple_cnn {str(dt)[6:]} B = {B_TIME}"
            if dt == torch.float32:
                block1_errs[kname].append(check_close(
                    what, run(), want, BLOCK1_ATOL, BLOCK1_RTOL))
            else:
                check_close(what, run(), want, BLOCK1_BF16_ATOL, 0.0)
        del want
        ab = {"simt": [], "new": []}
        for which in ("simt", "new", "new", "simt"):
            ab[which].append(graph_ms(runs[which]))
        plain_ms = cuda_ms(lambda st=st: cnn_kernel.cnn_block1_plain(
            st, big_feats), 10)
        block1_ab[str(dt)[6:]] = (ab, plain_ms)
    conv_w = stage.kernel.permute(3, 2, 0, 1).contiguous()
    conv_ms = graph_ms(lambda: F.conv2d(big_feats[:, None], conv_w, padding=1))
    fused = make_fused_cnn_forward(cnn, torch.float32)
    fused_ms = cuda_ms(lambda: fused(big_feats), 10)
    b1_bound = block1_bound(B_TIME, stage.stage)
    for dname, (ab, plain_ms) in block1_ab.items():
        log(f"  cnn_block1 simple_cnn {dname} (f32 features): A/B in turns "
            f"simt, new, new, simt: new (cnn_block1) {ab['new'][0]:.4f}, "
            f"{ab['new'][1]:.4f} ms; simt (cnn_block1_simt) "
            f"{ab['simt'][0]:.4f}, {ab['simt'][1]:.4f} ms = "
            f"{sum(ab['simt']) / sum(ab['new']):.2f}x (device times); plain "
            f"{plain_ms:.4f} ms; bound {b1_bound[0]:.4f} ms ({b1_bound[1]}: "
            f"bytes {b1_bound[2]:.4f} ms, operations {b1_bound[3]:.4f} ms); "
            f"F.conv2d alone (cuDNN, "
            f"TF32 off, a yardstick) {conv_ms:.4f} ms  ({card})")
    log(f"  make_fused_cnn_forward(simple_cnn) f32 end to end at B = {B_TIME}:"
        f" {fused_ms:.4f} ms; the block-1 kernel "
        f"{block1_ab['float32'][0]['new'][0]:.4f} ms of it = "
        f"{block1_ab['float32'][0]['new'][0] / fused_ms:.1%}  ({card})")
    times["cnn_block1"] = (block1_ab["float32"][0]["new"][0],
                           block1_ab["float32"][1])
    times["cnn_block1_simt"] = (block1_ab["float32"][0]["simt"][0],
                                block1_ab["float32"][1])
    # one PyTorch call computing the same function, where there is one; the
    # broadcast has none (a sum, then a copy), nor has any frontend (no
    # library call gives an MFCC), the GRU (a linear candidate is not
    # nn.GRU) or the fused CNNs (nor block 1: F.conv2d, timed above as a
    # yardstick, has no pool, bias or relu6); the LSTM's, cuDNN's nn.LSTM,
    # is timed with its A/B below
    library = dict.fromkeys(times)
    library["load_rowsum"] = cuda_ms(lambda: torch.sum(big, 1), 50)
    # (T, D, U, C), the same for both RNN checkpoints
    rnn_dims = (big_feats.shape[1], big_feats.shape[2],
                lstm_pretrained.backbone.lstm_unit_0.units,
                lstm_pretrained.num_classes)
    bounds = kernel_bounds(ListenerParams(), B_TIME, big.shape[1], rnn_dims,
                           cnn_cls.consts)
    # the GRU classifier: the tile kernel against the SIMT kernel in turns,
    # simt, tile, tile, simt, in each compute dtype (bf16 on bf16 features,
    # as the bf16 scorer hands them over), both first held to the plain
    # version at this batch; then the tile kernel's work splits.  Device
    # times, from CUDA graphs: the tile kernel is shorter than a call's host
    # work, whose share back-to-back calls show beside it
    gru_ab = {}
    gru_cell, gru_head = pretrained.backbone.gru_unit_0, pretrained.score_predict
    for dt in (torch.float32, torch.bfloat16):
        x = big_feats.to(dt)
        dname = str(dt)[6:]
        runs = {"tile": GRUClassifier(pretrained, dt),
                "simt": GRUClassifier(pretrained, dt, _simt=True)}
        with torch.inference_mode():
            want = pretrained(x.float(), dt)
        tol = (GRU_ATOL, GRU_RTOL) if dt == torch.float32 else (GRU_BF16_ATOL, 0.0)
        for which, run in runs.items():
            err = check_close(f"gru_classifier ({which}) {dname} B = {B_TIME}",
                              run(x), want, *tol)
            if dt == torch.float32:
                rnn_errs["gru" if which == "tile" else "gru_simt"].append(err)
        ab = {"simt": [], "tile": []}
        for which in ("simt", "tile", "tile", "simt"):
            ab[which].append(graph_ms(lambda: runs[which](x)))
        host_ms = cuda_ms(lambda: runs["tile"](x), 20)
        plain_ms = cuda_ms(lambda: pretrained(x.float(), dt), 5)
        bound = rnn_bound(B_TIME, rnn_dims, 3, dname)
        gru_ab[dname] = (ab, plain_ms, bound)
        if dt == torch.float32:
            times["gru_classifier"] = (ab["tile"][0], plain_ms)
            times["gru_classifier_simt"] = (ab["simt"][0], plain_ms)
            library["gru_classifier"] = library["gru_classifier_simt"] = None
        log(f"  gru_classifier {dname}: A/B in turns simt, tile, tile, simt: "
            f"tile (gru_classifier) {ab['tile'][0]:.4f}, {ab['tile'][1]:.4f} "
            f"ms; simt (gru_classifier_simt) {ab['simt'][0]:.4f}, "
            f"{ab['simt'][1]:.4f} ms = {sum(ab['simt']) / sum(ab['tile']):.2f}x"
            f" (device times); tile in back-to-back calls {host_ms:.4f} ms; "
            f"plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); "
            f"the gate math's SFU floor {sfu_floor_ms(B_TIME, rnn_dims, 4):.4f}"
            f" ms (information)  ({card})")
        pack = runs["tile"].packs[gru_cell]
        for split in gru_plan.SWEEP:
            def run_split(split=split):
                return rnn_kernel.gru_layer_cuda(
                    x, gru_cell.kernel, gru_cell.recurrent_kernel,
                    gru_cell.bias_input, gru_cell.bias_recurrent,
                    gru_head.kernel, gru_head.bias, dt, pack, _split=split)

            err = check_close(f"gru_classifier {dname} split {split}",
                              run_split(), want, *tol)
            if dt == torch.float32:
                rnn_errs["gru"].append(err)
            default = split == (gru_plan.ROWS, gru_plan.WARPS)
            log(f"    {dname} {split[0]} windows a warp, {split[1]} warps a "
                f"block{' (default)' if default else ''}: "
                f"{graph_ms(run_split):.4f} ms (device time)  ({card})")
    # the LSTM classifier the same way (the scorer runs it in f32), each
    # dtype beside cuDNN's nn.LSTM in that dtype (f32 held to the kernel;
    # bf16 keeps h and c in bf16 between steps, so its error is printed)
    lstm_ab = {}
    lstm_head = lstm_pretrained.score_predict
    for dt in (torch.float32, torch.bfloat16):
        x = big_feats.to(dt)
        dname = str(dt)[6:]
        runs = {"tile": LSTMClassifier(lstm_pretrained, dt),
                "simt": LSTMClassifier(lstm_pretrained, dt, _simt=True)}
        with torch.inference_mode():
            want = lstm_pretrained(x.float(), dt)
        tol = (GRU_ATOL, GRU_RTOL) if dt == torch.float32 else (GRU_BF16_ATOL, 0.0)
        for which, run in runs.items():
            err = check_close(f"lstm_classifier ({which}) {dname} B = {B_TIME}",
                              run(x), want, *tol)
            if dt == torch.float32:
                rnn_errs["lstm" if which == "tile" else "lstm_simt"].append(err)
        ab = {"simt": [], "tile": []}
        for which in ("simt", "tile", "tile", "simt"):
            ab[which].append(graph_ms(lambda: runs[which](x)))
        plain_ms = cuda_ms(lambda: lstm_pretrained(x.float(), dt), 5)
        bound = rnn_bound(B_TIME, rnn_dims, 4, dname)
        lstm_lib = cudnn_lstm(lstm_pretrained, dev, dt)
        with torch.inference_mode():
            lib_logits = (lstm_lib(x)[0][:, -1].float() @ lstm_head.kernel
                          + lstm_head.bias)
            lib_err = float((lib_logits - runs["tile"](x)).abs().max())
        if dt == torch.float32:
            check_close("cuDNN nn.LSTM (library yardstick) vs the LSTM kernel",
                        runs["tile"](x), lib_logits, GRU_ATOL, GRU_RTOL)
        lib_ms = cuda_ms(lambda: lstm_lib(x), 20)
        lstm_ab[dname] = (ab, plain_ms, bound, lib_ms)
        if dt == torch.float32:
            times["lstm_classifier"] = (ab["tile"][0], plain_ms)
            times["lstm_classifier_simt"] = (ab["simt"][0], plain_ms)
            library["lstm_classifier"] = library["lstm_classifier_simt"] = lib_ms
        log(f"  lstm_classifier {dname}: A/B in turns simt, tile, tile, simt: "
            f"tile (lstm_classifier) {ab['tile'][0]:.4f}, {ab['tile'][1]:.4f} "
            f"ms; simt (lstm_classifier_simt) {ab['simt'][0]:.4f}, "
            f"{ab['simt'][1]:.4f} ms = {sum(ab['simt']) / sum(ab['tile']):.2f}x"
            f" (device times); plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms"
            f" ({bound[1]}); the gate math's SFU floor "
            f"{sfu_floor_ms(B_TIME, rnn_dims, 10):.4f} ms (information); "
            f"cuDNN nn.LSTM {dname} {lib_ms:.4f} ms (back-to-back calls; "
            f"logits vs the tile kernel {lib_err:.1e})  ({card})")
    for name, (k_ms, p_ms) in times.items():
        lib = library[name]
        log(f"  {name:18s} kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})  library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}  (f32, {card})")
    log(f"  dft_frontend_bf16 kernel {times['dft_frontend_bf16'][0]:.4f} ms vs "
        f"FFT kernel (mfcc_frontend) {cuda_ms(lambda: fe(big), 20):.4f} ms, "
        f"same call, f32 audio and output  ({card})")
    # the CNN classifier: the tiled implicit GEMM against the SIMT kernel in
    # turns, simt, gemm, gemm, simt, each model and compute dtype (bf16 on
    # bf16 features), both first held to the plain version at this batch
    cnn_ab = {}
    for name, model in cnn_models.items():
        for dt in (torch.float32, torch.bfloat16):
            consts = CNNClassifier(model, dt).consts
            x = big_feats.to(dt)
            plain = cnn_kernel.cnn_classifier_plain(consts, x)
            runs = {"gemm": lambda: cnn_kernel.cnn_classifier_cuda(x, consts),
                    "simt": lambda: cnn_kernel.cnn_classifier_cuda(
                        x, consts, _simt=True)}
            for which, run in runs.items():
                kname = "cnn_classifier" + ("_simt" if which == "simt" else "")
                what = f"{kname} {name} {str(dt)[6:]} B = {B_TIME}"
                if dt == torch.float32:
                    cnn_errs[kname].append(check_close(what, run(), plain,
                                                       CNN_ATOL, CNN_RTOL))
                else:
                    check_close(what, run(), plain, CNN_BF16_ATOL, 0.0)
            ab = {"simt": [], "gemm": []}
            for which in ("simt", "gemm", "gemm", "simt"):
                ab[which].append(cuda_ms(runs[which], 20))
            plain_ms = cuda_ms(lambda: cnn_kernel.cnn_classifier_plain(consts, x),
                               10)
            bound = cnn_bound(consts.lowered, model.separable, B_TIME,
                              str(dt)[6:])
            cnn_ab[name, str(dt)[6:]] = (ab, plain_ms, bound)
            log(f"  cnn_classifier {name} {str(dt)[6:]}: A/B in turns simt, "
                f"gemm, gemm, simt: gemm (cnn_classifier) {ab['gemm'][0]:.4f}, "
                f"{ab['gemm'][1]:.4f} ms; simt (cnn_classifier_simt) "
                f"{ab['simt'][0]:.4f}, {ab['simt'][1]:.4f} ms = "
                f"{sum(ab['simt']) / sum(ab['gemm']):.2f}x; plain "
                f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}; "
                f"{cnn_flops(consts.lowered, model.separable) / 1e3:.3f} "
                f"kFLOP a window)  ({card})")
    for path, scorers in scorers_by_path.items():
        for dt, s in scorers.items():
            ms = cuda_ms(lambda: s(big), 10)
            log(f"  end to end {os.path.basename(path)} {str(dt)[6:]:8s} "
                f"{ms:.4f} ms/batch  {B_TIME / ms * 1e3:.0f} windows/s  ({card})")
    # the GRU checkpoint at route ct's config, f32 and bf16: card against
    # CPU on the clips, then timed end to end
    ct_path = with_params(CHECKPOINT, CT_ROUTE, route_dir)
    for dt in (torch.float32, torch.bfloat16):
        s = make_batch_scorer(ct_path, "cuda", dt)
        if s.paths["frontend"].split("(")[0] != "cuda-ct":
            raise AssertionError(f"paths {s.paths} do not name route ct")
        sc = s(clips_dev)
        cpu = make_batch_scorer(ct_path, "cpu", dt)(clips)
        top1 = [s.classes[i] for i in sc.argmax(-1).tolist()]
        top1_cpu = [s.classes[i] for i in cpu.argmax(-1).tolist()]
        log(f"  {str(dt)[6:]:8s} n_fft = window = 768 paths {s.paths}  top-1 "
            f"{sum(a == b for a, b in zip(top1, labels))}/8 {top1} (CPU "
            f"{top1_cpu})")
        atol = SCORE_ATOL if dt == torch.float32 else SCORE_BF16_ATOL
        check_close(f"scores card vs CPU, n_fft = window = 768 {str(dt)[6:]}",
                    sc.cpu(), cpu, atol, 0.0)
        ms = cuda_ms(lambda: s(big), 10)
        log(f"  end to end direction_simple_gru.npz at n_fft = window = 768 "
            f"{str(dt)[6:]:8s} {ms:.4f} ms/batch  {B_TIME / ms * 1e3:.0f} "
            f"windows/s  ({card})")

    # the stage cuts at this batch: each held to the plain version, then
    # timed with it and beside its bound; the deltas give each stage's cost
    cut_times, cut_bound = {}, {}  # (name, constant_block) -> ...
    for constant_block in (False, True):
        mode = "constant-block" if constant_block else "streamed"
        cb = cut_bounds(p0, B_TIME, big.shape[1], constant_block)
        for kernel, stages in omission_kernel.KERNELS.items():
            prev = None
            for stage in stages:
                def cut_launch(kernel=kernel, stage=stage, cbk=constant_block):
                    return omission_kernel.truncated(big, unit_gain, cut_consts,
                                                     p0, stage, kernel, cbk)

                def cut_plain(stage=stage, cbk=constant_block):
                    return omission_kernel.truncated_plain(
                        big, None, p0, stage, cbk, cut_consts.ct)

                name = omission_kernel.counter_name(kernel, stage)
                cut_errs[name].append(check_close(
                    f"{name} {mode} B = {B_TIME}", cut_launch(), cut_plain(),
                    *r3_omission.TOLERANCES[stage]))
                k_ms, p_ms = cuda_ms(cut_launch, 10), cuda_ms(cut_plain, 2)
                cut_times[name, constant_block] = (k_ms, p_ms)
                cut_bound[name, constant_block] = cb[name]
                delta = "" if prev is None else f"  delta {k_ms - prev:+.4f} ms"
                log(f"  {name:24s} {mode:14s} kernel {k_ms:.4f} ms{delta}  "
                    f"plain {p_ms:.4f} ms  bound {cb[name][0]:.4f} ms "
                    f"({cb[name][1]})  ({card})")
                prev = k_ms
    # a load cut reads every sample, as the TPU block copy does: it cannot
    # beat the load floor timed above in this run
    for kernel in omission_kernel.KERNELS:
        name = omission_kernel.counter_name(kernel, "load")
        ratio = cut_times[name, False][0] / times["load_rowsum"][0]
        log(f"  {name} streamed / load_rowsum {times['load_rowsum'][0]:.4f} ms"
            f" = {ratio:.3f}  ({card})")
        if ratio < 0.9:
            raise AssertionError(f"{name} takes {ratio:.3f}x the load floor: "
                                 "it does not read every sample")
    # each `full` cut against its shipped kernel, in turns
    shipped = {"fft": lambda: fe(big),
               "ct": lambda: ct_kernel.ct_frontend_cuda(big, unit_gain,
                                                        ct_consts, p0,
                                                        _split=True)}
    for kernel, run_shipped in shipped.items():
        name = omission_kernel.counter_name(kernel, "full")
        full_ab = {"shipped": [], "cut": []}
        for which in ("shipped", "cut", "cut", "shipped"):
            full_ab[which].append(cuda_ms(
                run_shipped if which == "shipped" else
                (lambda k=kernel: omission_kernel.truncated(
                    big, unit_gain, cut_consts, p0, "full", k)), 10))
        log(f"  {name} vs its shipped kernel, in turns shipped, cut, cut, "
            f"shipped: shipped {full_ab['shipped'][0]:.4f}, "
            f"{full_ab['shipped'][1]:.4f} ms; cut {full_ab['cut'][0]:.4f}, "
            f"{full_ab['cut'][1]:.4f} ms = "
            f"{sum(full_ab['cut']) / sum(full_ab['shipped']):.4f}x  ({card})")

    kernels = []
    for name, source, replaces, errs in (
            ("mfcc_frontend", frontend_kernel.SOURCE, frontend_kernel.REPLACES,
             frontend_errs),
            ("mfcc_frontend_radix2", frontend_kernel.SOURCE,
             frontend_kernel.REPLACES, radix2_errs),
            ("dft_frontend_bf16", frontend_kernel.DFT_SOURCE,
             frontend_kernel.DFT_REPLACES, fast_errs),
            ("dft_frontend_mma_sync", frontend_kernel.DFT_MMA_SYNC_SOURCE,
             frontend_kernel.DFT_REPLACES, mma_sync_errs),
            ("gru_classifier", rnn_kernel.SOURCE, rnn_kernel.REPLACES,
             rnn_errs["gru"]),
            ("gru_classifier_simt", rnn_kernel.SOURCE, rnn_kernel.REPLACES,
             rnn_errs["gru_simt"]),
            ("lstm_classifier", rnn_kernel.LSTM_SOURCE,
             rnn_kernel.LSTM_REPLACES, rnn_errs["lstm"]),
            ("lstm_classifier_simt", rnn_kernel.LSTM_SOURCE,
             rnn_kernel.LSTM_REPLACES, rnn_errs["lstm_simt"]),
            ("cnn_classifier", cnn_kernel.SOURCE, cnn_kernel.REPLACES,
             cnn_errs["cnn_classifier"]),
            ("cnn_classifier_simt", cnn_kernel.SOURCE, cnn_kernel.REPLACES,
             cnn_errs["cnn_classifier_simt"]),
            ("cnn_block1", cnn_kernel.BLOCK1_SOURCE, cnn_kernel.BLOCK1_REPLACES,
             block1_errs["cnn_block1"]),
            ("cnn_block1_simt", cnn_kernel.SOURCE, cnn_kernel.BLOCK1_REPLACES,
             block1_errs["cnn_block1_simt"]),
            ("dense_dft_combined", dense_dft_kernel.SOURCE,
             dense_dft_kernel.REPLACES, dense_errs["dense_dft_combined"]),
            ("dense_dft_halves", dense_dft_kernel.SOURCE,
             dense_dft_kernel.HALVES_REPLACES, dense_errs["dense_dft_halves"]),
            ("load_rowsum", load_kernel.SOURCE, load_kernel.REPLACES,
             load_errs["load_rowsum"]),
            ("load_broadcast", load_kernel.SOURCE,
             load_kernel.BROADCAST_REPLACES, load_errs["load_broadcast"]),
            ("mixed_fft_frontend", ct_kernel.MIXED_SOURCE,
             frontend_kernel.REPLACES, mixed_errs),
            *((name, ct_kernel.SOURCE, replaces, ct_errs[name])
              for name, (_, _, replaces) in ct_kernel.VARIANTS.items())):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs), "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": library[name],
        })
        if name.startswith("gru_classifier"):
            # in bf16 (bf16 features), from the A/B above
            ab, plain_ms, bound = gru_ab["bfloat16"]
            kernels[-1].update({
                "bf16_ms": ab["simt" if name.endswith("simt") else "tile"][0],
                "bf16_plain_ms": plain_ms, "bf16_bound_ms": bound[0],
                "bf16_bound_by": bound[1]})
        if name.startswith("lstm_classifier"):
            # in bf16 (bf16 features), from the A/B above
            ab, plain_ms, bound, lib_ms = lstm_ab["bfloat16"]
            kernels[-1].update({
                "bf16_ms": ab["simt" if name.endswith("simt") else "tile"][0],
                "bf16_plain_ms": plain_ms, "bf16_bound_ms": bound[0],
                "bf16_bound_by": bound[1], "bf16_library_ms": lib_ms})
        if name == "mixed_fft_frontend":
            # the A/B above: the split in the same call, and n_fft 1536 and
            # 2816 at hop 256
            ab, _, _ = mixed_ab[CT_ROUTE["n_fft"]]
            kernels[-1]["split_ms"] = ab["split"][0]
            for n_fft, _ in CT_AB[1:]:
                ab, plain_ms, bound = mixed_ab[n_fft]
                split = ab["split"][0] if "split" in ab else None
                kernels[-1][f"n_fft_{n_fft}"] = {
                    "ms": ab["new"][0], "split_ms": split, "plain_ms": plain_ms,
                    "bound_ms": bound[0], "bound_by": bound[1]}
        if name == "dft_frontend_bf16":
            # the A/B above: the first design in the same call; the DFT
            # product alone through cuBLAS, a yardstick (not the function)
            kernels[-1]["mma_sync_ms"] = fast_ab["mma_sync"][0]
            kernels[-1]["cublas_product_ms"] = cublas_ms
        if name == "ct_frontend_dup":
            # route ct's split-dup body at n_fft 4352
            kernels[-1]["n_fft_4352"] = {
                "ms": dup_ms, "plain_ms": dup_plain_ms,
                "bound_ms": dup_bound[0], "bound_by": dup_bound[1]}
        if name.startswith("cnn_block1"):
            # bf16 compute on f32 features, from the A/B above
            ab, plain_ms = block1_ab["bfloat16"]
            kernels[-1].update({
                "bf16_ms": ab["simt" if name.endswith("simt") else "new"][0],
                "bf16_plain_ms": plain_ms, "bf16_bound_ms": b1_bound[0],
                "bf16_bound_by": b1_bound[1],
                # F.conv2d alone: a yardstick for the conv, not the function
                "conv2d_ms": conv_ms, "fused_forward_ms": fused_ms})
        if name.startswith("cnn_classifier"):
            # simple_cnn in bf16 (bf16 features), from the A/B above
            ab, plain_ms, bound = cnn_ab["simple_cnn", "bfloat16"]
            kernels[-1].update({
                "bf16_ms": ab["simt" if name.endswith("simt") else "gemm"][0],
                "bf16_plain_ms": plain_ms, "bf16_bound_ms": bound[0],
                "bf16_bound_by": bound[1]})
    # the stage cuts: the main keys are the streamed cut's, the
    # constant_block_* keys the constant-block cut's; no library call
    # computes a cut
    for name in omission_kernel.counters:
        kernel = name.split("_", 1)[0]
        k_ms, p_ms = cut_times[name, False]
        c_ms, c_plain_ms = cut_times[name, True]
        kernels.append({
            "name": name, "route": "cuda",
            "source": (omission_kernel.CT_SOURCE if kernel == "ct"
                       else omission_kernel.FFT_SOURCE),
            "replaces": omission_kernel.REPLACES, "launches": launches[name],
            "max_abs_err": max(cut_errs[name]), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": cut_bound[name, False][0],
            "bound_by": cut_bound[name, False][1], "library_ms": None,
            "constant_block_ms": c_ms, "constant_block_plain_ms": c_plain_ms,
            "constant_block_bound_ms": cut_bound[name, True][0],
            "constant_block_bound_by": cut_bound[name, True][1],
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
