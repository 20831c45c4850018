#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA; print the card's name and power limit (nvidia-smi)
2. build    compile tpu_speech_commands_torch/csrc/*.cu with nvcc (sm_90a),
            one call a unit, all started together; each unit's seconds
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
            deltas, against the CT plain version; route ct's wide FFT (a
            frame over two or four warps) at every n_fft it takes (4352 ..
            15872) in the same four cases; the CT split's (F, T)
            instantiation ("split-dup", per_piece_mel=True) at n_fft 4352,
            10240 and 15872 in the same four cases, and, chosen from the
            config, at n_fft 4352 with 300, 512 and 600 filters and
            coefficients (blocks of 64, 32 and 32 rows; the coefficients in
            the idle T, ring and squares space, at 600 in their own
            region), f32 and int16 in, f32 and bf16 out; the FFT kernel at
            window
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
              (cuda-ct(wide), the wide FFT; split-dup's launch count must
              stay at 0): `.paths` must name the
              route, its kernels' launch counts must rise, and the scores
              must agree with the same scorer on the CPU;
            - MfccFrontend at n_fft 4352 with 300 coefficients (`.route`
              ct, `.body` split-dup: no wide block fits its 300 x 300 DCT)
              into GRUClassifier on a random 48-unit
              GRU of feature size 300 (its SIMT kernel): both launch counts
              rise and the scores agree with the CPU's;
            - the seven measurement entry points of tpu_speech_commands_torch
              .dev at their own batch (pallas_experiments B = 16384, every
              variant; the others B = 8192), a few iterations each: every
              checksum finite, r4's two frontends (dense: the gain applied,
              the last n_features frames) within its stated bound of a
              float64 reference, the CT variants within the f32 feature
              bound of the FFT kernel, r3_omission's cuts within their
              stage's bound of the plain version, and the dense-DFT,
              load-floor, CT and stage-cut launch counts must rise;
            - train: the port's `train.main` for simple_gru and simple_cnn
              with --augment, batch 32, 3 epochs, on a synthetic corpus
              (the 5 direction classes, 30 clips each, seed 1): the
              frontend kernel's and the classifier kernel's launch counts
              rise, the printed frontend names cuda-mfcc, every loss is
              finite, ep*.npz, trained_final.npz, metrics.csv, params.json
              and classes.txt exist; one train step on the card and one on
              the CPU (`dev.bench_train.make_step`, the builder phase 5
              times, over 5 classes) from the same init, batch and
              augmentation draws (dropout 0) give losses and parameters
              within 1e-4;
            - eval: the port's `eval.main` on the card and on the CPU for
              the four shipped checkpoints on the example clips (accuracy
              1.0) and for the two checkpoints just trained on the corpus:
              the confusion matrices must be equal, and the frontend and
              classifier kernels' launch counts rise;
            - streaming: `Listener.run_wav` for the four checkpoints on a
              wav of the eight clips, on the card and on the CPU: scores
              within the f32 card-vs-CPU bound, equal trigger events (at
              least 6), one bar a chunk, the classifier kernel's launch
              count rises (no SIMT kernel, no frontend kernel: the frame
              features are plain products, as in the JAX streamer);
              `python -m tpu_speech_commands_torch.listen` once, exit 0;
              `stream_server.main` with 8 slots over the eight clips, its
              events equal to its CPU run, one per clip;
            - export: for the four checkpoints, `export_native` equals
              pretrained/*.tscm byte for byte; the clips' features from the
              frontend kernel into the classifier kernel in f32 (both
              counts rise) are the reference that the `.onnx` (the numpy
              executor) meets within rtol 1e-4 / atol 1e-5 and the f32
              `.tscm` (the C++ runtime, built by g++) within rtol 1e-3 /
              atol 1e-4, and the q8 `.tscm`'s top-1 equals every label;
              `eval.main` on the `.onnx` and `.tscm` of simple_gru and
              simple_cnn over the synthetic corpus (the frontend kernel's
              count rises) within one sample of the `.npz` eval; a Listener
              and `stream_server` (8 slots) on the simple_gru `.onnx`:
              scores within 1e-4 of the `.npz` Listener's each chunk, and
              the same events.  The h5, SavedModel, TFLite and pb formats
              need TensorFlow: not run here;
            - parallel: `make_batch_scorer(..., mesh=)` with B = 8192 split
              over two shards (distinct cards where there are two or more,
              else two shards of cuda:0), simple_gru bf16 and simple_cnn
              f32: the frontend's and the classifier's launch counts rise
              once a shard, scores within 1e-6 of the one-device scorer's;
              `dev.dryrun_multichip` on 4 ranks (NCCL on 4 cards, else gloo
              with the ranks sharing cuda:0) at a global batch of 512: the
              simple_cnn step at data x model 2 x 2, hybrid 2 x 1 x 2, flat
              data 4 and replica x data 2 x 2 (each hybrid step bit-equal to
              its flat one), the --augment step (frontend kernel in every
              rank, dropout on) within 1e-5 of the one-device step, a
              feature epoch, an --augment epoch and a GRU epoch with
              validation, then evaluation and the scorer over a mesh of the
              same devices; each rank's frontend, GRU and CNN classifier
              launch counts (from its report) above 0, no JAX module in any
              rank; the same through one NCCL rank;
            - tools: `validate_speech_commands.main` on example/ for the
              simple_gru and simple_cnn `.npz` (frontend and classifier
              kernels) and `.tscm`: every clip's top-1 its label (eval's
              top-1 above); `mfcc_feature.main` on one clip: the frontend
              and fast_math kernels' features finite, the first within the
              f32 feature bound of the float64 oracle, the second within
              it of its plain chain and within FAST_MATH_ORACLE_ATOL of
              the oracle; `dump_inference_model.main` on the simple_gru
              checkpoint just trained: the same arrays, and scores (frontend
              and GRU kernels) equal to the input's; `dev.accuracy_parity`
              for simple_gru, seed 0, 36 classes x 8 clips, 3 epochs: the
              frontend kernel in the extraction, the GRU kernel in
              validation, a finite accuracy, and the committed easy stage
              file refused (another configuration) before any training;
            - user tools: `dev.make_pretrained.main` at the JAX script's
              recipe (four families, 5 classes x 80 clips, seed 1, batch
              64, 40 epochs) under build/chip_smoke/user_tools/: each
              family's training wall time, every `.npz` (frontend kernel,
              then the classifier kernel) and `.tscm` (frontend kernel,
              then the C++ runtime) 8/8 on the example clips, and the
              frontend, GRU, LSTM and CNN classifier launch counts rise;
              `audio_process.vad_clip --model_path` with the shipped and
              the port-trained simple_gru on noise, a word, noise: only
              the word's second flagged, the per-frame speech scores
              within SCORE_ATOL and the clips equal to a `--device cpu`
              run's; `dev.bench_native` on the port-written `.tscm`
              files (host CPU times, the CPU named); every other new tool
              once on a small corpus, no kernel launched (the pyaudio
              tools `--help` only, `plot_audio` where matplotlib imports)
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
            through cuBLAS (a yardstick), route ct's wide FFT against
            split-dup in turns, wide, split-dup, split-dup, wide, at n_fft
            4352, 10240 and 15872, beside the bound, the CT plain version
            and torch.fft.rfft plus the power alone (cuFFT, a yardstick),
            the FFT kernel's radix-2 body at n_fft = window = 8192 beside
            its bound and plain version, the GRU classifier's tile
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
            each `full` cut is timed in turns with its shipped kernel;
            route ct's split-dup body at n_fft 4352 with 300, 512 and 600
            coefficients beside its bound; the train step at B = 512
            for simple_gru and simple_cnn from `dev.bench_train` (its
            config: 36 classes, adam on a cosine decay; the step of
            `train.py --augment`: ms a step, samples/s, the frontend
            kernel's share; and on features, the JAX bench's) and
            `evaluate_accuracy` at batch 512 (samples/s), printed as a
            JSON line `{"train_eval": ...}`; the host's postprocess a tick
            (`dev.bench_postprocess`, scalar against vectorized, 1 and 1024
            slots), printed as `{"postprocess": ...}`; the streaming tick
            (`dev.bench_streaming`: ring update, frame features, the
            classifier kernel, softmax) at 1 and 1024 streams for
            simple_gru and simple_cnn, p50 / p90 / p99 ms a tick between
            two synchronizes and the headroom against the 64 ms chunk
            cadence, printed as a JSON line `{"streaming": ...}`; the
            sharded scorer's windows/s a card (`dev.bench_multichip`, B =
            8192 in all, simple_gru bf16 and simple_cnn f32: one shard and
            two shards sharing cuda:0 in turns, and one shard a card where
            there are two or more cards), printed as a JSON line
            `{"parallel_serving": ...}`

Two lines before the last: one JSON object describing each kernel, then the
card's name and power limit; the last line is {"ok": true, "device":
{...}}.  On a machine without CUDA the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import copy
import glob
import io
import json
import os
import shutil
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
# route ct above n_fft 4096 (the wide register FFT; the CT split's (F, T)
# instantiation, "split-dup", through per_piece_mel=True): the first size,
# one between and the longest window a 1 s buffer holds (one frame), where
# split-dup is checked and the two are timed in turns; the simple_gru
# scorer at the first
WIDE_AB = (4352, 10240, 15872)
WIDE_ROUTE = {"n_fft": 4352, "window_t": 0.272}
# route ct with more coefficients than one residue's T holds (n_filt =
# n_mfcc at n_fft 4352): blocks of 64 rows at 300 and of 32 at 512, both in
# the block's idle space; at 600 (32 rows) in a region of their own
MANY_COEFFS = (300, 512, 600)
# the train and eval slice: train.py's default batch, the corpus of
# .claude/skills/verify/SKILL.md step 1, the shipped class list
TRAIN_BATCH = 512
CLASSES_PATH = os.path.join(REPO, "configs", "direction_classes.txt")

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
# - one train step, card vs CPU (the frontend kernel against the plain chain,
#   then the same plain module, adam, from one init): the f32 feature bound
#   carried through one step, loss and every parameter
STEP_ATOL = 1e-4
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
        "wide_fft_frontend": frontend_bound(p.replace(**WIDE_ROUTE), batch),
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


def flat_variables(model) -> dict:
    from tpu_speech_commands_torch.training.checkpoints import (
        flatten_variables)

    return flatten_variables(model.variables())


def example_tree(root: str, class_names: list[str]) -> str:
    """example/*.wav copied into <root>/sounds/<label>/, a dataset of the
    eight clips (no background clip: that class is empty)."""
    shutil.rmtree(root, ignore_errors=True)
    for name in class_names:
        os.makedirs(os.path.join(root, "sounds", name))
    for path in sorted(glob.glob(os.path.join(REPO, "example", "*.wav"))):
        label = os.path.basename(path).split("_")[0]
        shutil.copy(path, os.path.join(root, "sounds", label))
    return root


def sounds_copy(src: str, dst: str) -> str:
    """A dataset of `src`'s wavs only, so that the features it caches are
    its own."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(src, "sounds"), os.path.join(dst, "sounds"))
    return dst


def drive_train_eval(dev, drive, clips, work: str) -> None:
    """Phase 4's train and eval slice on `dev` (the card; the CPU for a dry
    run), each path through `drive`: the port's train.main for simple_gru
    and simple_cnn with --augment on a synthetic corpus, one train step on
    `dev` against one on the CPU, and eval.main on `dev` and on the CPU for
    the four shipped checkpoints and the two just trained."""
    import torch

    from tpu_speech_commands_torch import eval as port_eval
    from tpu_speech_commands_torch import train as port_train
    from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
    from tpu_speech_commands_torch.dev import bench_train
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.params import ListenerParams, pr
    from tpu_speech_commands_torch.utils import get_classes

    pr.override(ListenerParams().to_dict())  # the checkpoints above set pr
    class_names = get_classes(CLASSES_PATH)
    shutil.rmtree(work, ignore_errors=True)
    on_card = dev.type == "cuda"
    kind = "cuda-mfcc" if on_card else "torch"
    corpus = make_synthetic_dataset(os.path.join(work, "ds"), class_names,
                                    samples_per_class=30, seed=1)
    eval_kernel = {"simple_gru": "gru_classifier",
                   "simple_lstm": "lstm_classifier",
                   "simple_cnn": "cnn_classifier",
                   "simple_cnn_lite": "cnn_classifier"}
    finals = {}
    for mt in ("simple_gru", "simple_cnn"):
        log_dir = os.path.join(work, f"logs_{mt}")
        args = port_train.build_parser().parse_args([
            "--model_type", mt, "--train_data_path", corpus,
            "--classes_path", CLASSES_PATH, "--batch_size", "32",
            "--epochs", "3", "--augment", "--log_dir", log_dir,
            "--device", str(dev)])
        printed = io.StringIO()

        def run_train(args=args, printed=printed):
            with contextlib.redirect_stdout(printed):
                return port_train.main(args)

        trainer = drive(f"train.main({mt}, --augment, batch 32, 3 epochs)",
                        run_train, ("mfcc_frontend", eval_kernel[mt]))
        for line in printed.getvalue().splitlines():
            log(f"  | {line}")
        if f"frontend: {kind} " not in printed.getvalue():
            raise AssertionError(f"train.main({mt}) did not print the "
                                 f"frontend's route {kind}")
        metrics = [(h.loss, h.val_loss) for h in trainer.history]
        if len(metrics) != 3 or not np.isfinite(metrics).all():
            raise AssertionError(f"train.main({mt}) epochs {metrics}")
        for name in ("trained_final.npz", "metrics.csv", "params.json",
                     "classes.txt"):
            if not os.path.exists(os.path.join(log_dir, name)):
                raise AssertionError(f"train.main({mt}) wrote no {name}")
        if not glob.glob(os.path.join(log_dir, "ep*.npz")):
            raise AssertionError(f"train.main({mt}) wrote no ep*.npz")
        finals[mt] = os.path.join(log_dir, "trained_final.npz")

    # one train step, card against CPU: dev.bench_train's step (the one
    # phase 5 times) of train.py --augment over 5 classes, adam at
    # train.py's constant rate, dropout 0, the same init, batch and
    # augmentation draws
    pr.override(ListenerParams().to_dict())
    step_audio = test_audio(clips, 64, seed=6)
    step_labels = np.arange(64) % 5
    for mt in ("simple_gru", "simple_cnn"):
        out = []
        for d in (dev, torch.device("cpu")):
            step, model, _, kind_d = bench_train.make_step(
                mt, TRAIN_BATCH, d, augment=True, num_classes=5,
                decay_type=None, noise_bank=step_audio[step_labels == 0],
                dropout_rate=0.0)
            want = kind if d == dev else "torch"
            if kind_d != want:
                raise AssertionError(f"training frontend {kind_d} is not "
                                     f"{want}")
            mask = torch.ones(64, device=d)
            mask[-5:] = 0.0
            loss, _ = step(torch.tensor(step_audio, device=d),
                           torch.tensor(step_labels, device=d), mask, 0)
            out.append((float(loss), flat_variables(model)))
        (loss, got), (cpu_loss, want) = out
        log(f"  one train step {mt}, card vs CPU: loss {loss:.6f} / "
            f"{cpu_loss:.6f}")
        if not abs(loss - cpu_loss) <= STEP_ATOL:
            raise AssertionError(f"train step {mt}: loss {loss} vs CPU "
                                 f"{cpu_loss}")
        err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        log(f"  one train step {mt}, card vs CPU: parameters max_abs_err "
            f"{err:.3e}  (atol {STEP_ATOL:g})")
        if not err <= STEP_ATOL:
            raise AssertionError(f"train step {mt}: parameters {err:.3e} from "
                                 "the CPU step's")

    # eval.main on the card and on the CPU, each on its own copy of the
    # data (the features it caches are its own): the four shipped
    # checkpoints on the example clips (8/8), then the two just trained
    evals = [(path, example_tree, "example clips") for path in
             (CHECKPOINT, LSTM_CHECKPOINT, *CNN_CHECKPOINTS.values())]
    evals += [(finals[mt], None, "the synthetic corpus") for mt in finals]
    for path, tree, what in evals:
        model_type = load_native(path, "cpu").model_type
        results = []
        for i, d in enumerate((str(dev), "cpu")):
            tag = f"{os.path.basename(os.path.dirname(path))}_" \
                  f"{os.path.basename(path)[:-4]}_{i}"
            data = (tree(os.path.join(work, f"examples_{tag}"), class_names)
                    if tree else sounds_copy(corpus,
                                             os.path.join(work, f"ds_{tag}")))
            args = port_eval.build_parser().parse_args([
                "--model_path", path, "--dataset_path", data,
                "--classes_path", CLASSES_PATH, "--output_path",
                os.path.join(work, "result"), "--device", d])
            label = (f"eval.main({os.path.relpath(path, REPO)}) on {what}, "
                     f"{d}")
            if i == 0:
                results.append(drive(
                    label, lambda args=args: port_eval.main(args),
                    ("mfcc_frontend", eval_kernel[model_type])))
            else:
                results.append(port_eval.main(args))
        (acc, conf), (cpu_acc, cpu_conf) = results
        log(f"  accuracy {acc:.4f} (CPU {cpu_acc:.4f}), confusion "
            f"{conf.astype(int).tolist()}")
        if tree and acc != 1.0:
            raise AssertionError(f"eval.main({path}): accuracy {acc} on the "
                                 "example clips")
        if not np.array_equal(conf, cpu_conf):
            raise AssertionError(f"eval.main({path}): the card's confusion "
                                 f"matrix {conf.tolist()} is not the CPU's "
                                 f"{cpu_conf.tolist()}")
    pr.override(ListenerParams().to_dict())


def time_train_eval(dev, big_feats, labels, card) -> dict:
    """Phase 5's train and eval times on `dev`: the train step at
    TRAIN_BATCH from dev.bench_train (features, and raw audio through the
    `--augment` pipeline), and evaluate_accuracy over big_feats' windows
    (clip i % 8's)."""
    import torch

    from tpu_speech_commands_torch.data.dataset import Dataset
    from tpu_speech_commands_torch.dev import bench_train
    from tpu_speech_commands_torch.evaluation import evaluate_accuracy
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.params import ListenerParams, pr
    from tpu_speech_commands_torch.serving import make_classifier

    # dev.bench_train.bench_model at train.py's default batch (512),
    # simple_gru and simple_cnn, on its config (36 classes, adam on a
    # cosine decay): the step of `train.py --augment` (augmentation and the
    # frontend kernel inside it; the frontend alone on the same batch
    # beside it) and the step on features (the JAX bench_train's); then
    # evaluate_accuracy at batch 512 on B_TIME windows' features, through
    # the classifier kernels
    pr.override(ListenerParams().to_dict())
    train_eval_times = {}
    for mt in ("simple_gru", "simple_cnn"):
        aug = bench_train.bench_model(mt, TRAIN_BATCH, iters=10, device=dev,
                                      augment=True)
        feat = bench_train.bench_model(mt, TRAIN_BATCH, iters=20, device=dev)
        train_eval_times[f"bench_train {mt} (36 classes, cosine adam)"] = {
            "step_ms": aug["step_ms"], "samples_per_s": aug["samples_per_s"],
            "frontend_ms": aug["frontend_ms"],
            "frontend_share": aug["frontend_share"],
            "features_step_ms": feat["step_ms"],
            "features_samples_per_s": feat["samples_per_s"]}
        log(f"  bench_train step {mt} (36 classes, cosine adam) "
            f"B = {TRAIN_BATCH} --augment: "
            f"{aug['step_ms']:.4f} ms/step  {aug['samples_per_s']:.0f} "
            f"samples/s; the frontend kernel {aug['frontend_ms']:.4f} ms = "
            f"{aug['frontend_share']:.1%} of the step; on features "
            f"{feat['step_ms']:.4f} ms/step {feat['samples_per_s']:.0f} "
            f"samples/s (dev.bench_train)  ({card})")
    n = len(big_feats)
    eval_labels = np.arange(n) % 8
    for mt, path in (("simple_gru", CHECKPOINT),
                     ("simple_cnn", CNN_CHECKPOINTS["simple_cnn"])):
        predictor = load_native(path, dev)
        classifier, _ = make_classifier(predictor.model, mt)
        ds = Dataset(big_feats.float().cpu().numpy(), np.array(
            [predictor.classes.index(labels[i]) for i in eval_labels],
            np.int32))

        def run_eval():
            return evaluate_accuracy(classifier, ds, mt, predictor.classes,
                                     batch_size=TRAIN_BATCH, save_plot=False,
                                     verbose=False)

        run_eval()  # warm-up; each run ends on a read of the counts
        t0 = time.perf_counter()
        acc, _ = run_eval()
        dt = time.perf_counter() - t0
        train_eval_times[f"evaluate_accuracy {mt}"] = {
            "samples_per_s": n / dt, "accuracy": acc}
        log(f"  evaluate_accuracy {mt} B = {TRAIN_BATCH}, {n} windows: "
            f"{n / dt:.0f} samples/s (accuracy {acc:.4f})  ({card})")
    pr.override(ListenerParams().to_dict())
    return train_eval_times


def drive_parallel(drive, launches: dict, work: str) -> dict:
    """Phase 4's parallel slice, each path through `drive`: the sharded
    scorer (`make_batch_scorer(..., mesh=)`, B = 8192 split over two shards:
    distinct cards where there are two or more, else two shards of cuda:0)
    against the one-device scorer for simple_gru in bf16 and simple_cnn in
    f32; `dev.dryrun_multichip` on 4 ranks (NCCL on 4 cards, else gloo with
    the 4 ranks sharing cuda:0) at a global batch of 512; and one NCCL rank
    through the same launcher.  Each rank's frontend, GRU and CNN
    classifier launch counts come from its report (the counters live in
    that process): each must be above 0, and they add to `launches`."""
    import torch

    from tpu_speech_commands_torch.dev import dryrun_multichip
    from tpu_speech_commands_torch.ops import (cnn_kernel, frontend_kernel,
                                               rnn_kernel)
    from tpu_speech_commands_torch.parallel import make_mesh
    from tpu_speech_commands_torch.serving import make_batch_scorer

    shutil.rmtree(work, ignore_errors=True)
    cards = torch.cuda.device_count()
    shards = ([f"cuda:{i}" for i in range(cards)] if cards >= 2
              else ["cuda:0", "cuda:0"])
    mesh = make_mesh(devices=shards)
    clips, _ = load_clips()
    audio = torch.tensor(test_audio(clips, B_TIME, seed=5), device="cuda:0")
    result = {"scorer": {}}
    for ckpt, dtype, kernel in (
            (CHECKPOINT, torch.bfloat16, rnn_kernel.gru_layer_cuda),
            (CNN_CHECKPOINTS["simple_cnn"], torch.float32,
             cnn_kernel.cnn_classifier_cuda)):
        name = os.path.basename(ckpt)
        want = make_batch_scorer(ckpt, "cuda:0", dtype)(audio)
        sharded = make_batch_scorer(ckpt, compute_dtype=dtype, mesh=mesh)
        kernel_name = "gru_classifier" if dtype == torch.bfloat16 else \
            "cnn_classifier"

        def run(sharded=sharded, kernel=kernel):
            got = sharded(audio)
            return got, (frontend_kernel.mfcc_frontend_cuda.launches,
                         kernel.launches)

        got, counts = drive(f"make_batch_scorer({name}, {str(dtype)[6:]}, "
                            f"mesh of {shards}), B = {B_TIME}", run,
                            ("mfcc_frontend", kernel_name))
        diff = float((got - want).abs().max())
        log(f"  paths {sharded.paths}: scores max|sharded - one device| "
            f"{diff:.3e}")
        if counts != (len(shards), len(shards)):
            raise AssertionError(f"launches {counts}: not one a shard")
        if sharded.paths["parallel"] != f"shards x{len(shards)}" or \
                not diff <= 1e-6:
            raise AssertionError(f"sharded scorer {sharded.paths}: {diff}")
        result["scorer"][name] = {"devices": shards, "dtype": str(dtype)[6:],
                                  "max_abs_diff": diff}
    four = ([f"cuda:{i}" for i in range(4)] if cards >= 4
            else ["cuda:0"] * 4)
    four_backend = "nccl" if cards >= 4 else "gloo"
    for label, devices, backend in (
            (f"4 ranks, {four_backend}", four, four_backend),
            ("1 rank, nccl", ["cuda:0"], "nccl")):
        out = os.path.join(work, f"dryrun_{len(devices)}")
        printed = io.StringIO()

        def run(devices=devices, backend=backend, out=out, printed=printed):
            with contextlib.redirect_stdout(printed):
                return dryrun_multichip.run(devices, backend, out, TRAIN_BATCH)

        summary = drive(f"dev.dryrun_multichip({label}: {devices}), global "
                        f"batch {TRAIN_BATCH}", run,
                        ("mfcc_frontend", "gru_classifier", "cnn_classifier"))
        for line in printed.getvalue().splitlines():
            log(f"  | {line}")
        for r, rank in enumerate(summary["ranks"]):
            log(f"  rank {r} on {rank['device']} ({backend}): launches "
                f"{rank['launches']}")
            if rank["foreign_modules"]:
                raise AssertionError(f"rank {r} loaded {rank['foreign_modules']}")
            for name, count in rank["launches"].items():
                if count < 1:
                    raise AssertionError(f"{name} kernel was not launched by "
                                         f"rank {r} of {label}")
                launches[name] += count
        log(f"  layouts {summary['layouts']}; --augment step on the ranks vs "
            f"one device: max|d| {summary['augment_vs_one_device']:.3e}")
        result[label] = {k: summary[k] for k in (
            "backend", "batch", "layouts", "augment_vs_one_device", "loss",
            "epoch_loss", "audio_pipeline_loss", "gru_loss",
            "gru_eval_accuracy", "serving")}
        result[label]["rank_launches"] = [r["launches"]
                                          for r in summary["ranks"]]
    return result


def time_parallel(card) -> dict:
    """The sharded scorer's windows/s (`dev.bench_multichip`), B = 8192 in
    all, simple_gru bf16 and simple_cnn f32: one shard on cuda:0 against
    two shards sharing it, in turns (one, two, two, one); with two or more
    cards, also one shard a card."""
    import torch

    from tpu_speech_commands_torch.dev import bench_multichip

    cases = [("one shard", "cuda:0", B_TIME),
             ("two shards sharing cuda:0", "cuda:0,cuda:0", B_TIME // 2)]
    order = (0, 1, 1, 0)
    cards = torch.cuda.device_count()
    if cards >= 2:
        cases.append((f"one shard a card, {cards} cards", str(cards),
                      B_TIME // cards))
        order += (2,)
    out = {}
    for model_type, dtype in (("simple_gru", "bfloat16"),
                              ("simple_cnn", "float32")):
        for i in order:
            label, devices, per_device = cases[i]
            with contextlib.redirect_stdout(io.StringIO()):
                r = bench_multichip.main([
                    "--devices", devices, "--model_type", model_type,
                    "--dtype", dtype, "--batch_per_device", str(per_device)])
            out.setdefault(f"{model_type} {dtype}, {label}", []).append(
                r["windows_per_s_per_card"])
            log(f"  sharded scorer {model_type} {dtype}, {label}: "
                f"{r['windows_per_s']:.0f} windows/s, "
                f"{r['windows_per_s_per_card']:.0f} a card ({card})")
    return out


def listen_recorded(listener, wav: str):
    """listener.run_wav(wav), recording each chunk's scores and each
    trigger event (chunk index, class index); returns (scores, events,
    printed lines)."""
    scores, events = [], []
    process, activate = listener.process_chunk, listener.on_activation

    def record_chunk(chunk):
        scores.append(process(chunk))
        return scores[-1]

    def record_event(index, play_activate=False):
        events.append((len(scores) - 1, index))
        activate(index, play_activate)

    listener.process_chunk, listener.on_activation = record_chunk, record_event
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        listener.run_wav(wav)
    return np.stack(scores), events, printed.getvalue().splitlines()


def drive_streaming(dev, drive, work: str) -> None:
    """Phase 4's streaming slice on `dev` (the card; the CPU for a dry run),
    each path through `drive`: Listener.run_wav for the four checkpoints
    on a wav of the eight example clips, held to the same Listener on the
    CPU; `python -m tpu_speech_commands_torch.listen` once; stream_server
    with 8 slots over the eight clips, held to its CPU run."""
    import subprocess

    import torch

    from tpu_speech_commands_torch import stream_server
    from tpu_speech_commands_torch.params import ListenerParams, pr
    from tpu_speech_commands_torch.streaming import Listener

    pr.override(ListenerParams().to_dict())
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    wavs = sorted(glob.glob(os.path.join(REPO, "example", "*.wav")))
    pcm = []
    for path in wavs:
        with wave.open(path, "rb") as wf:
            pcm.append(np.frombuffer(wf.readframes(wf.getnframes()), "<i2"))
    long_wav = os.path.join(work, "eight_clips.wav")
    with wave.open(long_wav, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(np.concatenate(pcm).tobytes())
    labels = [os.path.basename(w).split("_")[0] for w in wavs]
    kernel = {"simple_gru": "gru_classifier", "simple_lstm": "lstm_classifier",
              "simple_cnn": "cnn_classifier", "simple_cnn_lite": "cnn_classifier"}
    forbid = ("gru_classifier_simt", "lstm_classifier_simt",
              "cnn_classifier_simt", "mfcc_frontend")
    for path in (CHECKPOINT, LSTM_CHECKPOINT, *CNN_CHECKPOINTS.values()):
        out = {}
        for d in (dev, torch.device("cpu")):
            listener = Listener(model_path=path, classes_path=CLASSES_PATH,
                                device=d)
            label = (f"Listener.run_wav({os.path.relpath(path, REPO)}) on the "
                     f"eight clips, {d}")
            run = (lambda listener=listener:
                   listen_recorded(listener, long_wav))
            out[d.type] = (drive(label, run, (kernel[listener.predictor
                                                     .model_type],), forbid)
                           if d.type == "cuda" else run())
        (scores, events, lines), (cpu_scores, cpu_events, _) = (
            out[dev.type], out["cpu"])
        names = [listener.class_names[i] for _, i in events]
        log(f"  {len(scores)} chunks, events {events} = {names}")
        if scores.shape != (-(-len(np.concatenate(pcm)) // 1024), 5) or \
                not np.isfinite(scores).all():
            raise AssertionError(f"scores {scores.shape} not finite")
        check_close("Listener scores card vs CPU", torch.tensor(scores),
                    torch.tensor(cpu_scores), SCORE_ATOL, 0.0)
        if events != cpu_events:
            raise AssertionError(f"events {events} != CPU {cpu_events}")
        if len(lines) != len(scores) + len(events):
            raise AssertionError(f"{len(lines)} lines printed for "
                                 f"{len(scores)} chunks, {len(events)} events")
        if len(events) < 6 or not set(names) <= set(labels):
            raise AssertionError(f"events {names} on the clips {labels}")

    # the CLI once, in a process of its own, on the card (no launch
    # counts: they live in that process)
    cmd = [sys.executable, "-m", "tpu_speech_commands_torch.listen",
           "--model_path", CHECKPOINT, "--classes_path", CLASSES_PATH,
           "--input_wav", long_wav, "--device", str(dev)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    detected = [ln for ln in done.stdout.splitlines() if "detected" in ln]
    log(f"  python -m tpu_speech_commands_torch.listen: exit "
        f"{done.returncode} in {time.perf_counter() - t0:.1f} s, "
        f"{len(done.stdout.splitlines())} lines, {detected}")
    if done.returncode != 0 or len(detected) < 6:
        raise AssertionError(f"listen failed: {done.stderr[-2000:]}")

    # the server: 8 slots over the eight clips, card and CPU
    server = {}
    for d in (str(dev), "cpu"):
        argv = ["--model_path", CHECKPOINT, "--classes_path", CLASSES_PATH,
                "--wavs", *wavs, "--slots", "8", "--device", d]
        printed = io.StringIO()

        def run(argv=argv, printed=printed):
            with contextlib.redirect_stdout(printed):
                return stream_server.main(argv)

        server[d] = (drive("stream_server.main(8 slots, the eight clips)",
                           run, ("gru_classifier",), forbid)
                     if d != "cpu" else run())
        if d != "cpu":
            for line in printed.getvalue().splitlines():
                log(f"  | {line}")
    if server[str(dev)] != server["cpu"]:
        raise AssertionError(f"server events {server[str(dev)]} != CPU "
                             f"{server['cpu']}")
    if sorted(e["command"] for e in server["cpu"]) != sorted(labels):
        raise AssertionError(f"server events {server['cpu']} on {labels}")
    pr.override(ListenerParams().to_dict())


def host_ms(predict, feats) -> float:
    """An exported model's host time a window: the best of 3 calls on
    `feats`, host clock."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        predict(feats)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / len(feats)


def drive_export(dev, drive, work: str) -> None:
    """Phase 4's export slice on `dev` (the card; the CPU for a dry run),
    each path through `drive`, for the four shipped checkpoints: the port's
    `.tscm` equals the shipped one byte for byte; the eight clips'
    features from the frontend kernel into the classifier kernel in f32 are
    the reference scores, which the port's `.onnx` (the numpy executor) and
    f32 `.tscm` (the C++ runtime, built by g++ here) must meet, and the q8
    `.tscm` must keep each clip's label; eval.main on the `.onnx` and the
    `.tscm` of simple_gru and simple_cnn over the synthetic corpus (the
    frontend kernel for the features) within one sample of the native
    eval; a Listener and stream_server on the simple_gru `.onnx` against
    the native ones.  The `.onnx` runs on onnxruntime where it is
    installed, else on the port's numpy executor.  Every run of an
    exported file fails if a classifier kernel is launched in it, so its
    scores are the file's, not the kernels'."""
    import torch

    from tpu_speech_commands_torch import eval as port_eval
    from tpu_speech_commands_torch import stream_server
    from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
    from tpu_speech_commands_torch.export.inference_loader import (
        load_inference_model, load_native)
    from tpu_speech_commands_torch.export.native_format import export_native
    from tpu_speech_commands_torch.export.onnx_writer import export_onnx_model
    from tpu_speech_commands_torch.models import features_to_input, score_fn
    from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
    from tpu_speech_commands_torch.params import ListenerParams, pr
    from tpu_speech_commands_torch.serving import make_classifier
    from tpu_speech_commands_torch.streaming import Listener
    from tpu_speech_commands_torch.utils import get_classes

    pr.override(ListenerParams().to_dict())
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log("  not run by this script: the Keras h5, SavedModel, TFLite and pb "
        "formats (they need TensorFlow and h5py; "
        "tests/test_torch_export_tf.py holds them on the CPU); onnx runs "
        "on onnxruntime where it is installed, else the port's numpy "
        "executor")
    clips, labels = load_clips()
    clips_dev = torch.tensor(clips, device=dev)
    kernel = {"simple_gru": "gru_classifier", "simple_lstm": "lstm_classifier",
              "simple_cnn": "cnn_classifier", "simple_cnn_lite": "cnn_classifier"}
    classifiers = ("gru_classifier", "gru_classifier_simt", "lstm_classifier",
                   "lstm_classifier_simt", "cnn_classifier",
                   "cnn_classifier_simt", "cnn_block1", "cnn_block1_simt")
    exported = {}
    for path in (CHECKPOINT, LSTM_CHECKPOINT, *CNN_CHECKPOINTS.values()):
        name = os.path.basename(path)[:-len(".npz")]
        tscm = export_native(path, os.path.join(work, name + ".tscm"))
        with open(tscm, "rb") as a, open(path[:-4] + ".tscm", "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"export_native({name}) differs from "
                                     f"pretrained/{name}.tscm")
        log(f"  export_native({name}): {os.path.getsize(tscm)} bytes, equal "
            f"to pretrained/{name}.tscm")

        predictor = load_native(path, dev)
        mt = predictor.model_type
        frontend = MfccFrontend(pr.replace(),
                                predictor.meta.get("feature_type", "mfcc"), dev)
        classifier, _ = make_classifier(predictor.model, mt)

        def reference(frontend=frontend, classifier=classifier, mt=mt):
            feats = frontend(clips_dev)
            return feats, score_fn(classifier(features_to_input(feats, mt)))

        feats, ref = drive(f"reference scores of {name}: MfccFrontend, then "
                           "make_classifier f32, 8 clips", reference,
                           ("mfcc_frontend", kernel[mt]))
        feats, ref = feats.cpu().numpy(), ref.cpu()
        onnx = export_onnx_model(path, os.path.join(work, name + ".onnx"))
        q8 = export_native(path, os.path.join(work, name + "_q8.tscm"),
                           quantize=True)
        exported[mt] = {"onnx": onnx, "tscm": tscm}
        for model, (atol, rtol) in ((onnx, (1e-5, 1e-4)),
                                    (tscm, (1e-4, 1e-3))):
            predict, fmt = load_inference_model(model, dev)
            scores = drive(f"{fmt} {name} on the reference features",
                           lambda predict=predict: predict(feats), (),
                           classifiers)
            check_close(f"{fmt} {name} vs the kernels' scores",
                        torch.tensor(scores), ref, atol, rtol)
            log(f"  {fmt} {name} on the host: {host_ms(predict, feats):.4f} "
                "ms a window (best of 3, 8 windows a call)")
        predict, _ = load_inference_model(q8, dev)
        top1 = [predictor.classes[i] for i in predict(feats).argmax(-1)]
        log(f"  q8 .tscm {name}: {os.path.getsize(q8)} bytes, top-1 {top1}, "
            f"{host_ms(predict, feats):.4f} ms a window on the host")
        if top1 != labels:
            raise AssertionError(f"q8 {name}: top-1 {top1} != {labels}")

    # eval.main: each format on its own copy of the corpus, so the
    # frontend kernel makes every copy's features
    class_names = get_classes(CLASSES_PATH)
    corpus = make_synthetic_dataset(os.path.join(work, "ds"), class_names,
                                    samples_per_class=30, seed=1)
    for mt, path in (("simple_gru", CHECKPOINT),
                     ("simple_cnn", CNN_CHECKPOINTS["simple_cnn"])):
        accs = {}
        for fmt, model in (("npz", path), *exported[mt].items()):
            args = port_eval.build_parser().parse_args([
                "--model_path", model, "--dataset_path",
                sounds_copy(corpus, os.path.join(work, f"ds_{mt}_{fmt}")),
                "--classes_path", CLASSES_PATH, "--output_path",
                os.path.join(work, "result"), "--device", str(dev)])
            need, forbid = ((("mfcc_frontend", kernel[mt]), ())
                            if fmt == "npz" else
                            (("mfcc_frontend",), classifiers))
            printed = io.StringIO()

            def run(args=args, printed=printed):
                with contextlib.redirect_stdout(printed):
                    return port_eval.main(args)

            accs[fmt], conf = drive(f"eval.main({mt} .{fmt}) on the synthetic "
                                    "corpus", run, need, forbid)
            log(f"  accuracy {accs[fmt]:.4f} over {int(conf.sum())} clips")
        n = int(conf.sum())
        for fmt in exported[mt]:
            if abs(accs[fmt] - accs["npz"]) * n > 1 + 1e-9:
                raise AssertionError(f"eval {mt} .{fmt}: accuracy "
                                     f"{accs[fmt]} vs native {accs['npz']}")

    # a Listener and the server on the simple_gru .onnx against the native
    # .npz ones, over the eight clips
    long_wav = os.path.join(work, "eight_clips.wav")
    with wave.open(long_wav, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        pcm = []
        for wav in sorted(glob.glob(os.path.join(REPO, "example", "*.wav"))):
            with wave.open(wav, "rb") as rf:
                pcm.append(rf.readframes(rf.getnframes()))
        wf.writeframes(b"".join(pcm))
    onnx = exported["simple_gru"]["onnx"]
    runs = {}
    paths = ((CHECKPOINT, ("gru_classifier",), ()), (onnx, (), classifiers))
    for model, need, forbid in paths:
        listener = Listener(model_path=model, classes_path=CLASSES_PATH,
                            device=dev)
        runs[model] = drive(f"Listener.run_wav({os.path.basename(model)}) on "
                            "the eight clips",
                            lambda listener=listener:
                            listen_recorded(listener, long_wav), need, forbid)
    (scores, events, _), (onnx_scores, onnx_events, _) = (runs[CHECKPOINT],
                                                          runs[onnx])
    check_close("Listener .onnx vs .npz scores, each chunk",
                torch.tensor(onnx_scores), torch.tensor(scores), 1e-4, 0.0)
    log(f"  Listener events .npz {events}, .onnx {onnx_events}")
    if onnx_events != events or len(events) < 6:
        raise AssertionError(f"Listener .onnx events {onnx_events} != .npz "
                             f"{events}")
    wavs = sorted(glob.glob(os.path.join(REPO, "example", "*.wav")))
    served = {}
    for model, need, forbid in paths:
        argv = ["--model_path", model, "--classes_path", CLASSES_PATH,
                "--wavs", *wavs, "--slots", "8", "--device", str(dev)]

        def run(argv=argv):
            with contextlib.redirect_stdout(io.StringIO()):
                return stream_server.main(argv)

        served[model] = drive(f"stream_server.main({os.path.basename(model)},"
                              " 8 slots, the eight clips)", run, need,
                              forbid)
    log(f"  server events .onnx {[e['command'] for e in served[onnx]]}")
    if served[onnx] != served[CHECKPOINT]:
        raise AssertionError(f"server .onnx events {served[onnx]} != .npz "
                             f"{served[CHECKPOINT]}")
    pr.override(ListenerParams().to_dict())


def drive_tools(dev, drive, work: str, trained: str) -> dict:
    """Phase 4's tools slice on `dev` (the card; the CPU for a dry run),
    each path through `drive`:
    - the validator (`validate_speech_commands.main`) on example/ for the
      simple_gru and simple_cnn `.npz` (frontend and classifier kernels)
      and `.tscm` (frontend kernel, the C++ runtime): each clip's top-1 is
      its label, which is eval.main's top-1 on these clips (accuracy 1.0
      above);
    - the comparator (`mfcc_feature.main`) on one clip: the frontend and
      fast_math kernels' features finite, the first within the f32 feature
      bound of the float64 oracle, the second within it of its own plain
      chain on the CPU and within FAST_MATH_ORACLE_ATOL of the oracle;
    - `dump_inference_model.main` on `trained` (a checkpoint of the train
      slice): the same arrays, and the dump's scores on the clips' features
      (frontend and GRU kernels) equal the input's;
    - the accuracy-parity stage (`dev.accuracy_parity.main`): simple_gru,
      seed 0, 36 classes x 8 clips, 3 epochs: the frontend kernel in the
      extraction, the GRU kernel in validation, a finite accuracy; then the
      committed easy stage file, whose configuration differs, is refused
      before any training.
    Returns the tools' numbers."""
    import torch

    from tpu_speech_commands_torch import (dump_inference_model, mfcc_feature,
                                           validate_speech_commands)
    from tpu_speech_commands_torch.dev import (FAST_MATH_ORACLE_ATOL,
                                               FEAT_ATOL, FEAT_RTOL,
                                               accuracy_parity,
                                               check_features)
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.frontend.dsp import Frontend
    from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
    from tpu_speech_commands_torch.params import ListenerParams, pr
    from tpu_speech_commands_torch.serving import make_classifier

    t0 = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    wavs = sorted(glob.glob(os.path.join(REPO, "example", "*.wav")))
    labels = [os.path.basename(w).split("_")[0] for w in wavs]
    eval_kernel = {"simple_gru": "gru_classifier",
                   "simple_cnn": "cnn_classifier"}
    for mt, kernel in eval_kernel.items():
        for suffix, need in ((".npz", ("mfcc_frontend", kernel)),
                             (".tscm", ("mfcc_frontend",))):
            model = os.path.join(REPO, "pretrained", f"direction_{mt}{suffix}")
            pr.override(ListenerParams().to_dict())
            printed = io.StringIO()

            def run(model=model, printed=printed):
                with contextlib.redirect_stdout(printed):
                    return validate_speech_commands.main([
                        "--model_path", model, "--audio_path",
                        os.path.join(REPO, "example"), "--classes_path",
                        CLASSES_PATH, "--top_k", "2", "--loop_count", "20",
                        "--device", str(dev)])

            forbid = () if suffix == ".npz" else tuple(eval_kernel.values())
            results = drive(f"validate_speech_commands.main("
                            f"{os.path.basename(model)}, example/, top 2, "
                            "20 loops)", run, need, forbid)
            top1 = [r[0][0] for r in results]
            ms = [float(line.split(":")[1].strip()[:-2])
                  for line in printed.getvalue().splitlines()
                  if line.startswith("Average Inference time")]
            log(f"  validator {os.path.basename(model)}: top-1 {top1}, "
                f"{np.mean(ms):.4f} ms a prediction (mean of the clips)")
            if top1 != labels:
                raise AssertionError(f"validator {model}: top-1 {top1} is not "
                                     f"the clips' labels {labels}")
            out[f"validate {os.path.basename(model)}"] = {
                "top1": top1, "ms_a_prediction": float(np.mean(ms))}

    # the comparator on one clip
    pr.override(ListenerParams().to_dict())
    clip = os.path.join(REPO, "example", "left_1.wav")

    def run_comparator():
        with contextlib.redirect_stdout(io.StringIO()):
            return mfcc_feature.main(["--audio_file", clip, "--device",
                                      str(dev), "--output_path",
                                      os.path.join(work, "mfcc")])

    res = drive("mfcc_feature.main(example/left_1.wav)", run_comparator,
                ("mfcc_frontend", "dft_frontend_bf16"))
    oracle = torch.tensor(res["numpy_oracle"])
    fm_plain = Frontend(ListenerParams(), device="cpu", fast_math=True)(
        torch.tensor(mfcc_feature.load_padded(clip)[None],
                     dtype=torch.float32))[0]
    errs = {
        "frontend_kernel vs oracle": check_features(
            "comparator: frontend kernel vs the float64 oracle",
            torch.tensor(res["frontend_kernel"]), oracle),
        "fast_math_kernel vs its plain chain": check_features(
            "comparator: fast_math kernel vs its plain chain",
            torch.tensor(res["fast_math_kernel"]), fm_plain),
        "fast_math_kernel vs oracle": check_features(
            "comparator: fast_math kernel vs the float64 oracle",
            torch.tensor(res["fast_math_kernel"]), oracle,
            FAST_MATH_ORACLE_ATOL, 0.0),
    }
    if "native_cpp" in res:
        errs["native_cpp vs oracle"] = check_features(
            "comparator: native C++ vs the float64 oracle",
            torch.tensor(res["native_cpp"]), oracle)
    log(f"  comparator ({res['frontend_kernel_path']}, "
        f"{res['fast_math_kernel_path']}): max|delta| {errs}  (bounds atol "
        f"{FEAT_ATOL:g} + rtol {FEAT_RTOL:g}; fast_math vs oracle atol "
        f"{FAST_MATH_ORACLE_ATOL:g})")
    out["mfcc_feature max_abs_err"] = errs

    # dump_inference_model on the train slice's checkpoint
    dumped = os.path.join(work, "dumped.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        meta = dump_inference_model.main([
            "--checkpoint", trained, "--output_file", dumped,
            "--classes_path", CLASSES_PATH])
    with np.load(trained) as a, np.load(dumped) as b:
        if sorted(a.files) != sorted(b.files) or any(
                not np.array_equal(a[k], b[k]) for k in a.files
                if k != "__meta__"):
            raise AssertionError("dump_inference_model changed the arrays")
    clips, _ = load_clips()

    def score(path):
        predictor = load_native(path, dev)
        classifier, _ = make_classifier(predictor.model, predictor.model_type)
        fe = MfccFrontend(pr, "mfcc", dev)
        return classifier(fe(torch.tensor(clips, device=dev)))

    got = drive("dump_inference_model: the dump's scores on the clips",
                lambda: score(dumped), ("mfcc_frontend", "gru_classifier"))
    want = score(trained)
    if not torch.equal(got, want):
        raise AssertionError(f"the dump's scores differ from the input's by "
                             f"{float((got - want).abs().max()):.3e}")
    log(f"  dump_inference_model {os.path.relpath(trained, REPO)}: meta "
        f"{sorted(meta)}, scores equal the input's bit for bit")

    # the accuracy-parity stage, a smoke run
    pr.override(ListenerParams().to_dict())
    flags = ["--samples_per_class", "8", "--epochs", "3", "--seed", "0",
             "--model_type", "simple_gru", "--work_dir",
             os.path.join(work, "parity"), "--device", str(dev)]
    printed = io.StringIO()

    def run_parity():
        with contextlib.redirect_stdout(printed):
            return accuracy_parity.main(flags)

    stage = drive("dev.accuracy_parity.main(simple_gru, 36 x 8, 3 epochs)",
                  run_parity, ("mfcc_frontend", "gru_classifier"))
    acc = stage["simple_gru"]["0"]["acc"]
    log(f"  accuracy parity smoke: val_accuracy {acc:.4f} after 3 epochs")
    if not np.isfinite(acc):
        raise AssertionError(f"accuracy parity smoke: accuracy {acc}")
    committed = os.path.join(REPO, "docs", "parity",
                             "keras_stage_easy_371spc_100ep.json")
    def run_refused():
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                accuracy_parity.main(flags + ["--keras_stage", committed])
        except SystemExit as e:
            return str(e)
        return None

    refusal = drive("dev.accuracy_parity.main(--keras_stage of another "
                    "configuration)", run_refused, (), ("gru_classifier",))
    if refusal is None:
        raise AssertionError("accuracy parity: a stage file of another "
                             "configuration was not refused")
    if "recorded: " not in refusal or "current: " not in refusal:
        raise AssertionError(f"accuracy parity refusal names no values: "
                             f"{refusal}")
    log(f"  accuracy parity refusal: {refusal.splitlines()[0]}")
    out["parity smoke"] = {"acc": acc, "refused": refusal.splitlines()[0]}
    out["seconds"] = time.perf_counter() - t0
    log(f"  tools slice: {out['seconds']:.1f} s")
    pr.override(ListenerParams().to_dict())
    return out


def drive_user_tools(dev, drive, work: str) -> dict:
    """Phase 4's last tools slice on `dev` (the card), each path through
    `drive`:
    - `dev.make_pretrained.main` at the JAX script's full recipe (four
      families, 5 classes x 80 clips, seed 1, batch 64, 40 epochs) into
      `work`: each family's training wall time, every `.npz` (K1, then K3
      or K4) and `.tscm` (K1, then the C++ runtime) at 8/8 on the example
      clips, and the K1, K3 (gru, lstm) and K4 launch counts risen;
    - `audio_process.vad_clip --model_path` with the shipped and the
      port-trained simple_gru `.npz` on noise, a word, noise: exactly the
      word's second flagged (one clip, `long_3.wav`), the same clip bytes
      as a `--device cpu` run, K1 and K3 launched; the per-frame speech
      scores (`vad_clip.model_scores`) of the card's scorer within
      SCORE_ATOL of the CPU scorer's;
    - `dev.bench_native` on the port-written `.tscm` files: its JSON line,
      times on the host CPU it names;
    - every other new tool once on a small corpus, no kernel launched
      (the pyaudio tools `--help` only; `plot_audio` where matplotlib
      imports).
    Returns the slice's numbers."""
    import importlib

    import torch

    from tpu_speech_commands_torch.audio_process import vad_clip
    from tpu_speech_commands_torch.data.wav import save_audio
    from tpu_speech_commands_torch.dev import bench_native, make_pretrained
    from tpu_speech_commands_torch.params import ListenerParams, pr
    from tpu_speech_commands_torch.serving import make_batch_scorer

    t0 = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    models = os.path.join(work, "pretrained")
    pr.override(ListenerParams().to_dict())
    printed = io.StringIO()

    def run_make_pretrained():
        with contextlib.redirect_stdout(printed):
            try:
                return make_pretrained.main(["--out", models, "--device",
                                             str(dev)])
            except SystemExit as e:
                return e

    results = drive("dev.make_pretrained.main(4 families, 5 x 80 clips, "
                    "40 epochs)", run_make_pretrained,
                    ("mfcc_frontend", "gru_classifier", "lstm_classifier",
                     "cnn_classifier"))
    with open(os.path.join(work, "make_pretrained.log"), "w") as f:
        f.write(printed.getvalue())
    for line in printed.getvalue().splitlines():
        if "trained in" in line or "example accuracy" in line:
            log("  " + line)
    if isinstance(results, SystemExit):
        raise AssertionError(f"make_pretrained: {results}")
    out["make_pretrained"] = results
    pr.override(ListenerParams().to_dict())

    # the learned VAD, card against CPU, on the shipped and the new GRU
    rec = os.path.join(work, "vad_in", "long.wav")
    os.makedirs(os.path.dirname(rec))
    audio = vad_clip.noise_word_noise(rec)
    for name, ckpt in (("shipped", CHECKPOINT), ("port-trained", os.path.join(
            models, "direction_simple_gru.npz"))):
        speech = {}
        for d in (dev, "cpu"):
            scorer = make_batch_scorer(ckpt, d)
            speech[d] = vad_clip.model_scores(
                audio, scorer, scorer.params.max_samples, 16000)
            pr.override(ListenerParams().to_dict())
        err = float(np.max(np.abs(speech[dev] - speech["cpu"])))
        log(f"  vad_clip {name} simple_gru: speech scores {speech[dev]} "
            f"(card), max |card - CPU| {err:.3g} (atol {SCORE_ATOL})")
        if speech[dev].shape != (5,) or err > SCORE_ATOL:
            raise AssertionError(f"vad_clip {name}: card scores "
                                 f"{speech[dev]}, CPU {speech['cpu']}")
        clips = {}
        for d in (dev, "cpu"):
            dst = os.path.join(work, f"vad_{name}_{torch.device(d).type}")
            argv = ["--input_path", rec, "--output_path", dst,
                    "--model_path", ckpt, "--device", str(d)]

            def run(argv=argv):
                with contextlib.redirect_stdout(io.StringIO()):
                    return vad_clip.main(argv)

            if d == dev:
                written = drive(f"audio_process.vad_clip --model_path "
                                f"{name} simple_gru", run,
                                ("mfcc_frontend", "gru_classifier"))
            else:
                written = run()
            clips[d] = []
            for w in written:
                with open(w, "rb") as f:
                    clips[d].append((os.path.basename(w), f.read()))
        names = [n for n, _ in clips[dev]]
        log(f"  vad_clip {name} simple_gru: clips {names} (card), "
            f"{[n for n, _ in clips['cpu']]} (CPU)")
        if names != ["long_3.wav"]:
            raise AssertionError(f"vad_clip {name}: clips {names}, not the "
                                 "word's second alone (long_3.wav)")
        if clips[dev] != clips["cpu"]:
            raise AssertionError(f"vad_clip {name}: the card's clips differ "
                                 "from the CPU's")
        out[f"vad_clip {name}"] = {"clips": names, "score_max_abs_err": err}

    # the native apps on the port-written .tscm files (host CPU times)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        bench = bench_native.main(["--model_dir", models, "--loop_count",
                                   "200", "--runs", "3"])
    for line in printed.getvalue().splitlines():
        log("  bench_native: " + line)
    if bench is None or [r["family"] for r in bench["rows"]] != \
            bench_native.FAMILIES:
        raise AssertionError(f"bench_native: rows {bench}")
    out["bench_native"] = {"host_cpu": bench_native.host_cpu(), **bench}

    # every other new tool once, on a small corpus; no kernel
    corpus = os.path.join(work, "corpus")
    rng = np.random.default_rng(0)
    tt = np.arange(16000) / 16000.0
    for sub, freq in (("a", 300), ("b", 900)):
        os.makedirs(os.path.join(corpus, "wavs", sub))
        save_audio(os.path.join(corpus, "wavs", sub, "tone.wav"),
                   0.4 * np.sin(2 * np.pi * freq * tt)
                   + 0.01 * rng.standard_normal(16000))
    save_audio(os.path.join(corpus, "wavs", "quiet.wav"), np.zeros(16000))
    os.makedirs(os.path.join(corpus, "stereo"))
    with wave.open(os.path.join(corpus, "stereo", "st.wav"), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes((rng.standard_normal((16000, 2)) * 3000)
                       .astype("<i2").tobytes())
    with open(os.path.join(corpus, "ann.jsonl"), "w") as f:
        f.write(json.dumps({"audio_filepath": "/old/a.wav"}) + "\n")
    wavs, o = os.path.join(corpus, "wavs"), os.path.join(work, "tools_out")
    runs = [
        ("audio_process.white_noise", ["--output_path", f"{o}/noise",
                                       "--count", "2", "--seed", "1"]),
        ("audio_process.add_noise", ["--voice_path", wavs, "--noise_path",
                                     f"{o}/noise", "--output_path",
                                     f"{o}/noisy", "--seed", "2"]),
        ("audio_process.audio_convert", ["--input_path", wavs,
                                         "--output_path", f"{o}/conv",
                                         "--sample_rate", "8000",
                                         "--sample_bit", "24"]),
        ("audio_process.audio_reverberation", ["--input_path", wavs,
                                               "--output_path", f"{o}/rev",
                                               "--seed", "1"]),
        ("audio_process.audio_split", ["--input_path", wavs, "--output_path",
                                       f"{o}/split", "--chunk_time", "0.5"]),
        ("audio_process.split_channel", ["--input_path",
                                         os.path.join(corpus, "stereo"),
                                         "--output_path", f"{o}/chan"]),
        ("audio_process.wav_filter", ["--input_path", wavs, "--output_path",
                                      f"{o}/filt", "--cutoff", "500"]),
        ("audio_process.wav_merge", ["--voice_path", wavs, "--noise_path",
                                     f"{o}/noise/white_noise_0.wav",
                                     "--output_path", f"{o}/merge"]),
        ("audio_process.speech_command_split", ["--wav_path", rec]),
        ("audio_process.speech_duration_check", ["--input_path", rec]),
        ("audio_process.vad_clip", ["--input_path", rec, "--output_path",
                                    f"{o}/vad_energy"]),
        ("audio_process.silent_check", ["--input_path", wavs]),
        ("audio_process.wav_check", ["--input_path", wavs]),
        ("audio_process.wav_play", ["--wav_path", wavs, "--info_only"]),
        ("audio_process.annotation_update", [
            "--annotation_file", os.path.join(corpus, "ann.jsonl"),
            "--output_file", f"{o}/ann.jsonl", "--old_prefix", "/old",
            "--new_prefix", "/new"]),
        ("dev.make_chimes", ["--all", "--output_dir", f"{o}/chimes"]),
        *((f"audio_process.{tool}", ["--help"])
          for tool in ("audio_play", "audio_record", "wav_play")),
    ]
    try:
        import matplotlib  # noqa: F401

        runs.append(("plot_audio", ["--audio_file", rec, "--output_file",
                                    f"{o}/plot.png"]))
    except ImportError:
        log("  plot_audio: matplotlib does not import here (a CPU tool; "
            "tests/test_torch_pretrained.py runs it)")

    def run_tools():
        for entry, argv in runs:
            module = importlib.import_module(
                f"tpu_speech_commands_torch.{entry}")
            with contextlib.redirect_stdout(io.StringIO()) as text:
                try:
                    module.main(argv)
                except SystemExit as e:  # --help
                    if e.code not in (0, None):
                        raise
            if not text.getvalue().strip():
                raise AssertionError(f"{entry} {argv} printed nothing")

    drive(f"{len(runs)} host tool runs on a small corpus", run_tools, (),
          ("mfcc_frontend", "gru_classifier", "lstm_classifier",
           "cnn_classifier"))
    files = sum(len(fs) for _, _, fs in os.walk(o))
    log(f"  host tools: {len(runs)} runs, {files} files written")
    out["host tools"] = {"ran": sorted({e for e, _ in runs}), "files": files}
    out["seconds"] = time.perf_counter() - t0
    log(f"  user tools slice: {out['seconds']:.1f} s")
    pr.override(ListenerParams().to_dict())
    return out


def time_streaming(card) -> dict:
    """Phase 5's streaming ticks: dev.bench_streaming at 1 and 1024 streams
    for simple_gru and simple_cnn, on the card."""
    from tpu_speech_commands_torch.dev import bench_streaming

    times = {}
    for mt in ("simple_gru", "simple_cnn"):
        for streams in (1, 1024):
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                r = bench_streaming.main(["--model_type", mt, "--streams",
                                          str(streams), "--iters", "300"])
            times[f"{mt} streams {streams}"] = r
            log(f"  stream tick {mt} streams {streams}: p50 "
                f"{r['p50_ms']:.4f} p90 {r['p90_ms']:.4f} p99 "
                f"{r['p99_ms']:.4f} ms (device span p50 "
                f"{r['device_span_p50_ms']:.4f}; alone: update "
                f"{r['update_p50_ms']:.4f}, classifier "
                f"{r['classifier_p50_ms']:.4f}), headroom "
                f"{r['headroom_p50']:.1f}x / {r['headroom_p99']:.1f}x "
                f"against {r['budget_ms']:.0f} ms  ({card})")
    return times


def time_postprocess() -> list:
    """Phase 5's host postprocess a tick (dev.bench_postprocess): the
    scalar loop and the vectorized step at 1 and 1024 slots, each firing
    the same triggers."""
    from tpu_speech_commands_torch.dev import bench_postprocess

    rows = [bench_postprocess.bench(n) for n in (1, 1024)]
    for r in rows:
        log(f"  postprocess {r['slots']} slots: scalar {r['scalar_ms']:.4f} "
            f"vector {r['vector_ms']:.4f} ms a tick ({r['speedup']:.1f}x), "
            f"{r['fired']} triggers each (host)")
    return rows


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
    from tpu_speech_commands_torch import eval as port_eval
    from tpu_speech_commands_torch import train as port_train
    from tpu_speech_commands_torch.data.dataset import Dataset
    from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
    from tpu_speech_commands_torch.evaluation import evaluate_accuracy
    from tpu_speech_commands_torch.models import init_model
    from tpu_speech_commands_torch.params import ListenerParams, pr
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.serving import (make_batch_scorer,
                                                   make_classifier)
    from tpu_speech_commands_torch.utils import get_classes

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
    if info.compiled:
        log("  each unit's nvcc, all started together: " + ", ".join(
            f"{unit} {secs:.1f} s" for unit, secs in sorted(
                info.unit_seconds.items(), key=lambda kv: -kv[1])))
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
    # route ct above n_fft 4096: the wide register FFT, chosen from the
    # config, at every n_fft it takes, in the mixed FFT's four cases, held
    # to the CT plain version (the constants built once a size: they do not
    # depend on the deltas)
    wide_errs = []
    for n_fft in sorted(fft_plan.WIDE_PLANS):
        consts = None
        for audio, out_dtype, gain, time_major, delta in mixed_cases:
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000,
                               use_delta=delta)
            consts = consts or ct_kernel.CtConstants(p, "mfcc", dev)
            if consts.body != "wide":
                raise AssertionError(f"n_fft {n_fft}: route ct's body is "
                                     f"{consts.body}, not wide")
            gain_t = torch.full((1,), gain, dtype=torch.float32, device=dev)
            got = ct_kernel.ct_frontend_cuda(audio, gain_t, consts, p,
                                             time_major=time_major,
                                             out_dtype=out_dtype)
            torch.cuda.synchronize()
            want = ct_kernel.ct_frontend_plain(audio, gain, consts, p,
                                               time_major=time_major,
                                               out_dtype=out_dtype)
            what = (f"wide_fft_frontend n_fft {n_fft} "
                    f"{'time' if time_major else 'batch'}-major"
                    f"{' deltas' if delta else ''} {str(audio.dtype)[6:]}->"
                    f"{str(out_dtype)[6:]} ({consts.layout.warps} warps)")
            if out_dtype == torch.float32:
                wide_errs.append(check_close(what, got, want, FEAT_ATOL,
                                             FEAT_RTOL))
            else:
                check_close(what, got, want, FEAT_BF16_ATOL, FEAT_BF16_RTOL)
        del consts
    # the CT split's (F, T) instantiation ("split-dup", per_piece_mel=True)
    # at both ends of those sizes and one between, in the same four cases,
    # held to the CT plain version (its per-piece-mel form)
    for n_fft in WIDE_AB:
        for audio, out_dtype, gain, time_major, delta in mixed_cases:
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000,
                               use_delta=delta)
            consts = ct_kernel.CtConstants(p, "mfcc", dev)
            gain_t = torch.full((1,), gain, dtype=torch.float32, device=dev)
            got = ct_kernel.ct_frontend_cuda(audio, gain_t, consts, p,
                                             per_piece_mel=True,
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
    # route ct with more coefficients than one residue's T holds: 300, 512
    # and 600 filters and coefficients at n_fft 4352, split-dup from the
    # config (the coefficients in the idle T, ring and squares space, at
    # 600 in their own region), f32 and int16 in, f32 and bf16 out,
    # held to the CT plain version
    for n in MANY_COEFFS:
        p = ListenerParams(n_fft=4352, window_t=0.272, n_filt=n, n_mfcc=n)
        for audio, out_dtype in ((audio_f32, torch.float32),
                                 (audio_i16, torch.float32),
                                 (audio_f32, torch.bfloat16),
                                 (audio_i16, torch.bfloat16)):
            fe = MfccFrontend(p, "mfcc", dev, out_dtype=out_dtype)
            if (fe.route, fe.body) != ("ct", "split-dup"):
                raise AssertionError(f"{n} coefficients: route {fe.route}, "
                                     f"body {fe.body}, not ct split-dup")
            got = fe(audio, 0.9)
            torch.cuda.synchronize()
            want = ct_kernel.ct_frontend_plain(audio, 0.9, fe.consts, p,
                                               per_piece_mel=True,
                                               out_dtype=out_dtype)
            what = (f"ct_frontend_dup n_fft 4352, {n} coefficients "
                    f"({ct_kernel.split_rows(p, True)} rows) "
                    f"{str(audio.dtype)[6:]}->{str(out_dtype)[6:]}")
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
        "wide_fft_frontend": ct_kernel.WIDE,
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
         ("mixed_fft_frontend", "gru_classifier"),
         ("wide_fft_frontend", *ct_kernel.counters)),
        ("window 1200 > n_fft 1024", {"window_t": 0.075}, "cuda-mfcc",
         ("mfcc_frontend", "gru_classifier"), ()),
        ("n_fft 8192 (the radix-2 body)", {"n_fft": 8192}, "cuda-mfcc",
         ("mfcc_frontend_radix2", "gru_classifier"), ()),
        ("n_fft 400", {"n_fft": 400, "window_t": 0.025}, "torch(xla-route)",
         ("gru_classifier",), ()),
        ("n_fft = window = 4352 (route ct's wide body)", WIDE_ROUTE,
         "cuda-ct(wide)", ("wide_fft_frontend", "gru_classifier"),
         ("mixed_fft_frontend", *ct_kernel.counters)),
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

    # route ct with 300 coefficients (more than one residue's T holds)
    # into the GRU classifier: a random 48-unit GRU of feature size 300
    # (init_model, seed 1; no shipped checkpoint has this config), whose
    # input width takes the GRU's SIMT kernel; card against CPU
    p300 = ListenerParams(n_fft=4352, window_t=0.272, n_filt=300, n_mfcc=300)
    gru300, _ = init_model("simple_gru", 5, seed=1, params=p300)
    fe300 = MfccFrontend(p300, "mfcc", dev)
    if (fe300.route, fe300.body, fe300.path) != ("ct", "split-dup",
                                                 "cuda-ct(split-dup)"):
        raise AssertionError(f"300 coefficients: route {fe300.route}, body "
                             f"{fe300.body}, path {fe300.path}")
    cls300 = GRUClassifier(copy.deepcopy(gru300).to(dev))
    sc = drive("MfccFrontend (n_fft 4352, 300 coefficients) + GRUClassifier "
               "(random, D 300) on 8 clips",
               lambda: score_fn(cls300(fe300(clips_dev))),
               ("ct_frontend_dup", "gru_classifier_simt"),
               ("mixed_fft_frontend", "wide_fft_frontend", "ct_frontend",
                "gru_classifier"))
    cpu300 = score_fn(GRUClassifier(gru300)(
        MfccFrontend(p300, "mfcc", "cpu")(torch.tensor(clips))))
    check_close("scores card vs CPU, n_fft 4352, 300 coefficients", sc.cpu(),
                cpu300, SCORE_ATOL, 0.0)

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

    drive_train_eval(dev, drive, clips, os.path.join(
        REPO, "build", "chip_smoke", "train_eval"))
    drive_streaming(dev, drive, os.path.join(REPO, "build", "chip_smoke",
                                             "streaming"))
    drive_export(dev, drive, os.path.join(REPO, "build", "chip_smoke",
                                          "export"))
    log(json.dumps({"tools": drive_tools(
        dev, drive, os.path.join(REPO, "build", "chip_smoke", "tools"),
        os.path.join(REPO, "build", "chip_smoke", "train_eval",
                     "logs_simple_gru", "trained_final.npz"))}))
    log(json.dumps({"user_tools": drive_user_tools(
        dev, drive, os.path.join(REPO, "build", "chip_smoke", "user_tools"))}))
    log(json.dumps({"parallel": drive_parallel(
        drive, launches, os.path.join(REPO, "build", "chip_smoke",
                                      "parallel"))}))


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
    # route ct above n_fft 4096: the wide FFT against split-dup
    # (per_piece_mel=True) in turns, wide, split-dup, split-dup, wide, both
    # first held to the CT plain version at this batch, beside the bound,
    # the CT plain version and, as a yardstick only (not the function; the
    # port never calls it), torch.fft.rfft of the kept frames and the power
    # alone (cuFFT)
    wide_ab = {}
    for n_fft in WIDE_AB:
        p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000)
        consts = ct_kernel.CtConstants(p, "mfcc", dev)
        runs = {"wide": lambda: ct_kernel.ct_frontend_cuda(big, unit_gain,
                                                           consts, p),
                "split-dup": lambda: ct_kernel.ct_frontend_cuda(
                    big, unit_gain, consts, p, per_piece_mel=True)}
        want = ct_kernel.ct_frontend_plain(big, None, consts, p)
        wide_errs.append(check_close(
            f"wide_fft_frontend n_fft {n_fft} B = {B_TIME}", runs["wide"](),
            want, FEAT_ATOL, FEAT_RTOL))
        ct_errs["ct_frontend_dup"].append(check_close(
            f"ct_frontend_dup (split-dup) n_fft {n_fft} B = {B_TIME}",
            runs["split-dup"](), want, FEAT_ATOL, FEAT_RTOL))
        del want
        ab = {"wide": [], "split-dup": []}
        for which in ("wide", "split-dup", "split-dup", "wide"):
            ab[which].append(cuda_ms(runs[which],
                                     20 if which == "wide" else 3))
        plain_ms = cuda_ms(lambda: ct_kernel.ct_frontend_plain(big, None,
                                                               consts, p), 2)
        frames = frame_signal(big, p.n_fft, p.hop_samples)[:, -p.n_features:]
        cufft_ms = cuda_ms(lambda: torch.fft.rfft(frames).abs().square(), 5)
        del frames
        bound = frontend_bound(p, B_TIME)
        wide_ab[n_fft] = {
            "ms": ab["wide"][0], "split_dup_ms": ab["split-dup"][0],
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "cufft_power_ms": cufft_ms}
        log(f"  route ct at n_fft = window = {n_fft} ({p.n_features} frames),"
            f" B = {B_TIME}, f32 audio and output, in turns wide, split-dup, "
            f"split-dup, wide: wide FFT (wide_fft_frontend, "
            f"{consts.layout.warps} warps a block) {ab['wide'][0]:.4f}, "
            f"{ab['wide'][1]:.4f} ms; split-dup (ct_frontend_dup) "
            f"{ab['split-dup'][0]:.4f}, {ab['split-dup'][1]:.4f} ms = "
            f"{sum(ab['split-dup']) / sum(ab['wide']):.2f}x; CT plain "
            f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); "
            f"torch.fft.rfft + power alone (cuFFT, a yardstick) "
            f"{cufft_ms:.4f} ms  ({card})")
        del consts
    # the FFT kernel's radix-2 body at n_fft = window = 8192 (the one size
    # in route ct's series that route fft takes; its register body stops
    # at 4096), beside its bound and the plain chain
    p8k = ListenerParams(n_fft=8192, window_t=0.512)
    fe8k = MfccFrontend(p8k, "mfcc", dev)
    radix2_errs.append(check_close(
        f"frontend (radix-2 body) n_fft 8192 B = {B_TIME}", fe8k(big),
        fe8k.plain(big), FEAT_ATOL, FEAT_RTOL))
    bound = frontend_bound(p8k, B_TIME)
    radix2_8k = {"ms": cuda_ms(lambda: fe8k(big), 5),
                 "plain_ms": cuda_ms(lambda: fe8k.plain(big), 2),
                 "bound_ms": bound[0], "bound_by": bound[1]}
    log(f"  FFT kernel, radix-2 body (mfcc_frontend_radix2) at n_fft = "
        f"window = 8192 "
        f"({p8k.n_features} frames), B = {B_TIME}, f32 audio and output: "
        f"{radix2_8k['ms']:.4f} ms; plain {radix2_8k['plain_ms']:.4f} ms; "
        f"bound {bound[0]:.4f} ms ({bound[1]})  ({card})")
    del fe8k
    # split-dup with 300, 512 and 600 coefficients (blocks of 64, 32 and 32
    # rows: no wide block fits their DCT), beside its bound
    many_ms = {}
    for n in MANY_COEFFS:
        p_many = ListenerParams(n_filt=n, n_mfcc=n, **WIDE_ROUTE)
        many_consts = ct_kernel.CtConstants(p_many, "mfcc", dev)
        ms = cuda_ms(lambda: ct_kernel.ct_frontend_cuda(
            big, unit_gain, many_consts, p_many), 3)
        bound = frontend_bound(p_many, B_TIME)
        many_ms[n] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
        log(f"  split-dup at n_fft 4352 with {n} coefficients "
            f"({ct_kernel.split_rows(p_many, True)} rows), B = {B_TIME}: "
            f"{ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})  ({card})")
        del many_consts
    times = {
        "wide_fft_frontend": (wide_ab[WIDE_AB[0]]["ms"],
                              wide_ab[WIDE_AB[0]]["plain_ms"]),
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

    log(json.dumps({"train_eval": time_train_eval(
        dev, big_feats, labels, card), "card": card}))
    log(json.dumps({"postprocess": time_postprocess(), "card": card}))
    log(json.dumps({"streaming": time_streaming(card), "card": card}))
    log(json.dumps({"parallel_serving": time_parallel(card), "card": card}))

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
            ("wide_fft_frontend", ct_kernel.WIDE_SOURCE,
             frontend_kernel.REPLACES, wide_errs),
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
        if name == "wide_fft_frontend":
            # the A/B above: split-dup in the same call, the cuFFT yardstick
            kernels[-1]["cufft_power_ms"] = wide_ab[WIDE_AB[0]]["cufft_power_ms"]
            kernels[-1]["split_dup_ms"] = wide_ab[WIDE_AB[0]]["split_dup_ms"]
            for n_fft in WIDE_AB[1:]:
                kernels[-1][f"n_fft_{n_fft}"] = wide_ab[n_fft]
        if name == "mfcc_frontend_radix2":
            kernels[-1]["n_fft_8192"] = radix2_8k
        if name == "ct_frontend_dup":
            # split-dup at n_fft 4352, from the A/B above, and with many
            # coefficients
            kernels[-1]["n_fft_4352"] = {
                key: wide_ab[4352][key] for key in ("plain_ms", "bound_ms",
                                                    "bound_by")}
            kernels[-1]["n_fft_4352"]["ms"] = wide_ab[4352]["split_dup_ms"]
            for n, entry in many_ms.items():
                kernels[-1][f"n_fft_4352_{n}_coefficients"] = entry
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
