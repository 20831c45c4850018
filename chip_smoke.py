#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   require CUDA; print the card's name and power limit (nvidia-smi)
2. build    compile tpu_speech_commands_torch/csrc/*.cu with nvcc (sm_90a)
3. kernels  each kernel against its plain PyTorch version on the card, at
            B = 1000, over the configs and dtypes the slice can meet
4. slice    make_batch_scorer("pretrained/direction_simple_gru.npz", "cuda")
            scores the eight example/*.wav clips in f32 and bf16: top-1 must
            equal every file's label, `.paths` must name both kernels, both
            launch counts must rise, and the scores must agree with the same
            scorer run on the CPU (plain versions)
5. times    CUDA-event times at B = 8192, audio resident on the card: each
            kernel against its plain version, and end-to-end windows/s
            (information only)

The line before the last is one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  On a machine without CUDA the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
import wave

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")
B_CHECK = 1000   # not a multiple of any tile either kernel uses
B_TIME = 8192    # the serving batch the JAX benchmark measured

# Tolerances, each with its reason:
# - features f32: the kernel's radix-2 FFT and the plain dense-DFT matmul
#   sum in different orders, and the log of a small mel energy magnifies
#   the difference; the bound tests/test_frontend_jax.py holds the f32
#   frontend to against the float64 oracle.
FEAT_ATOL, FEAT_RTOL = 2e-3, 1e-3
# - features bf16: the f32 bound plus one bf16 rounding step (2^-7 relative)
FEAT_BF16_ATOL, FEAT_BF16_RTOL = 2e-3, 1e-3 + 2.0 ** -7
# - GRU logits f32: same math, f32 sums in another order over 30 steps
GRU_ATOL, GRU_RTOL = 1e-4, 1e-5
# - GRU logits bf16: rounding of bf16 products can flip at a boundary and
#   grow over the recurrence; the bound tests/test_serving.py allows bf16
GRU_BF16_ATOL = 5e-2
# - scores f32, card vs CPU: the feature bound carried through the GRU
SCORE_ATOL = 1e-3
SCORE_BF16_ATOL = 5e-2


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


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
    from tpu_speech_commands_torch.frontend.dsp import Frontend
    from tpu_speech_commands_torch.models.rnn import SimpleGRU
    from tpu_speech_commands_torch.ops import _build, frontend_kernel, rnn_kernel
    from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
    from tpu_speech_commands_torch.ops.rnn_kernel import GRUClassifier
    from tpu_speech_commands_torch.params import ListenerParams
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.serving import make_batch_scorer

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
    frontend_errs = []
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
    for name, kw, ftype, audio, out_dtype, gain in cases:
        p = ListenerParams(**kw)
        fe = MfccFrontend(p, ftype, dev, out_dtype=out_dtype)
        got = fe(audio, gain)
        torch.cuda.synchronize()
        want = fe.plain(audio, gain).to(out_dtype)
        assert got.dtype == out_dtype
        what = (f"frontend {name} {ftype} {str(audio.dtype)[6:]}->"
                f"{str(out_dtype)[6:]} gain {gain}")
        if out_dtype == torch.float32:
            frontend_errs.append(
                check_close(what, got, want, FEAT_ATOL, FEAT_RTOL))
        else:
            check_close(what, got, want, FEAT_BF16_ATOL, FEAT_BF16_RTOL)

    feats = Frontend(ListenerParams(), "mfcc", dev)(audio_f32)
    pretrained = load_native(CHECKPOINT, dev).model
    stacked = SimpleGRU(5, 20, 48, num_layers=2).to(dev)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for prm in stacked.parameters():
            prm.copy_(torch.tensor(
                0.1 * rng.standard_normal(tuple(prm.shape)), dtype=torch.float32))
    gru_errs = []
    for label, model in (("1 layer, pretrained", pretrained),
                         ("2 layers, random", stacked)):
        for dtype in (torch.float32, torch.bfloat16):
            cls = GRUClassifier(model, dtype)
            x = feats.to(dtype)
            got = cls(x)
            torch.cuda.synchronize()
            with torch.inference_mode():
                want = model(x.float(), dtype)
            what = f"gru {label} {str(dtype)[6:]}"
            if dtype == torch.float32:
                gru_errs.append(check_close(what, got, want, GRU_ATOL, GRU_RTOL))
            else:
                check_close(what, got, want, GRU_BF16_ATOL, 0.0)

    # -- 4. the slice ----------------------------------------------------------
    scorers = {dt: make_batch_scorer(CHECKPOINT, "cuda", dt)
               for dt in (torch.float32, torch.bfloat16)}
    clips_dev = torch.tensor(clips, device=dev)
    frontend_kernel.mfcc_frontend_cuda.launches = 0
    rnn_kernel.gru_layer_cuda.launches = 0
    scores = {dt: s(clips_dev) for dt, s in scorers.items()}
    torch.cuda.synchronize()
    launches = {
        "mfcc_frontend": frontend_kernel.mfcc_frontend_cuda.launches,
        "gru_classifier": rnn_kernel.gru_layer_cuda.launches,
    }
    log(f"slice: {os.path.relpath(CHECKPOINT, REPO)} on 8 example clips, "
        f"launches {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} kernel was not launched by the slice")
    for dt, s in scorers.items():
        if s.paths["frontend"].split("(")[0] != "cuda-mfcc" or \
                s.paths["classifier"] != "cuda-gru":
            raise AssertionError(f"paths {s.paths} do not name both kernels")
        sc = scores[dt]
        if sc.shape != (8, s.num_classes) or not torch.isfinite(sc).all():
            raise AssertionError(f"scores {tuple(sc.shape)} not finite (8, C)")
        top1 = [s.classes[i] for i in sc.argmax(-1).tolist()]
        n_ok = sum(a == b for a, b in zip(top1, labels))
        log(f"  {str(dt)[6:]:8s} paths {s.paths}  top-1 {n_ok}/8 {top1}")
        if top1 != labels:
            raise AssertionError(f"top-1 {top1} != labels {labels}")
        cpu = make_batch_scorer(CHECKPOINT, "cpu", dt)(clips)
        atol = SCORE_ATOL if dt == torch.float32 else SCORE_BF16_ATOL
        check_close(f"scores card vs CPU {str(dt)[6:]}", sc.cpu(), cpu, atol, 0.0)

    # -- 5. times (information only) -------------------------------------------
    log(f"times at B = {B_TIME}, audio resident on the card ({card}):")
    big_np = test_audio(clips, B_TIME, seed=2)
    big = torch.tensor(big_np, device=dev)
    fe = MfccFrontend(ListenerParams(), "mfcc", dev)
    big_feats = fe(big)
    cls = GRUClassifier(pretrained, torch.float32)
    times = {
        "mfcc_frontend": (cuda_ms(lambda: fe(big), 20),
                          cuda_ms(lambda: fe.plain(big), 5)),
        "gru_classifier": (cuda_ms(lambda: cls(big_feats), 20),
                           cuda_ms(lambda: pretrained(big_feats), 5)),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"  {name:16s} kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"(f32, {card})")
    cls16 = GRUClassifier(pretrained, torch.bfloat16)
    feats16 = big_feats.to(torch.bfloat16)
    log(f"  gru_classifier   kernel bf16 {cuda_ms(lambda: cls16(feats16), 20):.4f}"
        f" ms  plain bf16 "
        f"{cuda_ms(lambda: pretrained(feats16.float(), torch.bfloat16), 5):.4f}"
        f" ms  ({card})")
    for dt, s in scorers.items():
        ms = cuda_ms(lambda: s(big), 10)
        log(f"  end to end {str(dt)[6:]:8s} {ms:.4f} ms/batch  "
            f"{B_TIME / ms * 1e3:.0f} windows/s  ({card})")

    kernels = []
    for name, mod, errs in (("mfcc_frontend", frontend_kernel, frontend_errs),
                            ("gru_classifier", rnn_kernel, gru_errs)):
        kernels.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches[name],
            "max_abs_err": max(errs), "ms": times[name][0],
            "plain_ms": times[name][1],
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
