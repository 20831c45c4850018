#!/usr/bin/env python3
"""The fused frontend paths, the classifier tiles and the default scorers
of two checkouts timed in turns on the card: the FFT kernel's register
body at the default config (f32 and bf16 out), `fast_math`
(csrc/dft_wgmma.cu) at the default config, route ct's mixed-radix FFT at
n_fft = window = 768 (f32 and bf16 out) and 1536 (hop 256), route ct's
wide FFT at 4352, and route fft's wide body at n_fft = window = 8192 and
at 16384 (window 12800); the GRU and LSTM classifiers' tile kernels at the
shipped shape (the pretrained 48-unit models on (B, 30, 20) features, f32
and bf16 on bf16 features; device times from CUDA graphs); and
`make_batch_scorer` end to end for the four shipped checkpoints, f32 and
bf16, on B windows of audio.

    python tpu_speech_commands_torch/dev/checkout_ab.py --other DIR
        [--batch 8192] [--iters 50]

Each turn is a process of its own (this file with `--worker --root ROOT`)
that imports the package from ROOT, so that each checkout runs its own
wrappers on its own build (`ROOT/build/torch_kernels/`), in the order
other, this, this, other.  A worker builds (printing the register
kernels' spills where it compiles), holds each config's features at
B_CHECK windows to its plain chain within FEAT_ATOL / FEAT_RTOL (plus
BF16_STEP for bf16 out), then times `MfccFrontend` on B windows of random
audio resident on the card: CUDA events over `--iters` calls after a
warm-up, twice (the tiles: `graph_ms`, twice; the scorers: their scores
first held to the CPU scorer's on B_CHECK windows within SCORE_ATOL, f32,
or SCORE_BF16_ATOL).  The last line is a JSON object of every turn's
times.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# label: (ListenerParams keywords, fast_math, out dtype)
CONFIGS = {
    "register body, 1024": ({}, False, "float32"),
    "register body, 1024, bf16 out": ({}, False, "bfloat16"),
    "fast_math, 1024": ({}, True, "float32"),
    "mixed FFT, 768": ({"n_fft": 768, "window_t": 0.048}, False, "float32"),
    "mixed FFT, 768, bf16 out": ({"n_fft": 768, "window_t": 0.048}, False,
                                 "bfloat16"),
    "mixed FFT, 1536, hop 256": ({"n_fft": 1536, "window_t": 0.096,
                                  "hop_t": 0.016}, False, "float32"),
    "route ct wide FFT, 4352": ({"n_fft": 4352, "window_t": 0.272}, False,
                                "float32"),
    "route fft wide body, 8192": ({"n_fft": 8192, "window_t": 0.512}, False,
                                  "float32"),
    "route fft wide body, 16384, window 12800": (
        {"n_fft": 16384, "window_t": 0.8}, False, "float32"),
}
B_CHECK = 256
BF16_STEP = 2.0 ** -7
CHECKPOINTS = ("simple_gru", "simple_lstm", "simple_cnn", "simple_cnn_lite")
# scores card against CPU: the feature bound through the classifier, f32
# (chip_smoke.SCORE_ATOL); bf16, the bound tests/test_serving.py allows
SCORE_ATOL, SCORE_BF16_ATOL = 1e-3, 5e-2


def _cuda_ms(fn, iters: int) -> list:
    """CUDA events over `iters` calls after a warm-up, twice."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def classifiers_and_scorers(root: str, batch: int, iters: int, dev,
                            out: dict) -> None:
    """The tiles at the shipped shape and the four scorers (see above) of
    ROOT's package into out["ms"] / out["max_abs_err"]."""
    import numpy as np
    import torch

    from tpu_speech_commands_torch.dev import graph_ms
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.ops.rnn_kernel import (GRUClassifier,
                                                          LSTMClassifier)
    from tpu_speech_commands_torch.serving import make_batch_scorer

    rng = np.random.default_rng(1)
    feats = torch.tensor(rng.standard_normal((batch, 30, 20)),
                         dtype=torch.float32, device=dev)
    for name, cls in (("simple_gru", GRUClassifier),
                      ("simple_lstm", LSTMClassifier)):
        model = load_native(os.path.join(root, "pretrained",
                                         f"direction_{name}.npz"), dev).model
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            run, x = cls(model, dt), feats.to(dt)
            out["ms"][f"{name} tile, {dtype}"] = [
                graph_ms(lambda: run(x), iters) for _ in range(2)]
    audio = torch.tensor(0.3 * rng.standard_normal((batch, 16000),
                                                   dtype=np.float32),
                         device=dev)
    check = audio[:B_CHECK]
    for name in CHECKPOINTS:
        path = os.path.join(root, "pretrained", f"direction_{name}.npz")
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            scorer = make_batch_scorer(path, dev, dt)
            want = make_batch_scorer(path, "cpu", dt)(check.cpu())
            err = float((scorer(check).cpu() - want).abs().max())
            atol = SCORE_ATOL if dtype == "float32" else SCORE_BF16_ATOL
            if not err <= atol:
                raise AssertionError(f"{name} {dtype} scorer: {err:.2e} from "
                                     f"the CPU's, past {atol}")
            label = f"{name} scorer, {dtype}"
            out["max_abs_err"][label] = err
            out["ms"][label] = _cuda_ms(lambda: scorer(audio), iters)
            out.setdefault("path", {})[label] = scorer.paths["classifier"]


def worker(root: str, batch: int, iters: int) -> dict:
    """One turn: ROOT's package, built, checked and timed (see above)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from tpu_speech_commands_torch.dev import (FEAT_ATOL, FEAT_RTOL,
                                               check_features)
    from tpu_speech_commands_torch.ops import _build
    from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
    from tpu_speech_commands_torch.params import ListenerParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    _build.load_library()
    info = getattr(_build, "build_info", None)
    spills, entry = [], ""
    if info is not None and info.compiled:
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill" in line and "0 bytes spill stores, 0 bytes" \
                    not in line:
                spills.append(f"{entry}: {line.strip()}")
    out = {"root": root, "spills": spills, "ms": {}, "max_abs_err": {}}
    rng = np.random.default_rng(0)
    for label, (kw, fast_math, dtype) in CONFIGS.items():
        p = ListenerParams(**kw)
        fe = MfccFrontend(p, "mfcc", dev, out_dtype=getattr(torch, dtype),
                          fast_math=fast_math)
        check = torch.tensor(0.3 * rng.standard_normal(
            (B_CHECK, p.max_samples), dtype=np.float32), device=dev)
        # bf16 out: the f32 bound plus one bf16 rounding step
        rtol = FEAT_RTOL + (BF16_STEP if dtype == "bfloat16" else 0.0)
        out["max_abs_err"][label] = check_features(
            f"{label} ({fe.path})", fe(check).float(), fe.plain(check).float(),
            FEAT_ATOL, rtol)
        del check
        audio = torch.tensor(0.3 * rng.standard_normal(
            (batch, p.max_samples), dtype=np.float32), device=dev)
        out["ms"][label] = _cuda_ms(lambda: fe(audio), iters)
        out.setdefault("path", {})[label] = fe.path
        del audio, fe
        torch.cuda.empty_cache()
    classifiers_and_scorers(root, batch, iters, dev, out)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root")
    args = ap.parse_args(argv)
    if args.worker:
        result = worker(args.root, args.batch, args.iters)
        print(json.dumps(result), flush=True)
        return result
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    roots = {"other": os.path.abspath(args.other), "this": THIS_ROOT}
    turns = []
    for tag in ("other", "this", "this", "other"):
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", "--root",
             roots[tag], "--batch", str(args.batch), "--iters",
             str(args.iters)], capture_output=True, text=True, check=False)
        if done.returncode:
            print(done.stdout[-4000:], done.stderr[-8000:], flush=True)
            raise RuntimeError(f"the {tag} turn exited {done.returncode}")
        result = json.loads(done.stdout.strip().splitlines()[-1])
        result["tag"] = tag
        turns.append(result)
        for line in result["spills"]:
            print(f"{tag} build: {line}", flush=True)
    for label in turns[0]["ms"]:
        row = {tag: [t for turn in turns if turn["tag"] == tag
                     for t in turn["ms"][label]] for tag in roots}
        ratio = sum(row["this"]) / sum(row["other"])
        path = turns[1].get("path", {}).get(label, "tile kernel")
        print(f"{label:42s} other " + ", ".join(f"{t:.4f}" for t in
                                                 row["other"])
              + "; this " + ", ".join(f"{t:.4f}" for t in row["this"])
              + f" ms; this / other {ratio:.4f} ({path}; "
              f"B = {args.batch}, {card})", flush=True)
    summary = {"card": card, "batch": args.batch, "iters": args.iters,
               "turns": turns}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
