"""Build the pretrained direction models with the port (counterpart of
`tools/dev/make_pretrained.py`, with its flags and recipe, and
`--device`).

    python -m tpu_speech_commands_torch.dev.make_pretrained \\
        [--out build/pretrained_torch] [--models simple_gru ...] [--device cpu]

The recipe is the JAX script's: the deterministic synthetic direction set
(`data/synthetic.py`, 5 classes x `--samples_per_class` 80, seed 1), then
one `train.main` run a family at batch 64, 40 epochs, BatchNorm momentum
0.9 and cosine decay, in this process on one device (`--device`, the
current card for `cuda`; `train.main` on a card with an index trains on
that card alone).
On the card (the default) the frontend kernel extracts the features and
the classifier kernel runs every validation pass.  Each checkpoint is
copied to `<out>/direction_<family>.npz` and exported to `.tscm`
(`export/native_format.py::export_native`); then both are verified on the
checked-in `example/*.wav` clips: the `.npz` through `pad_audio`, the
frontend kernel and the classifier kernel, the `.tscm` through the C++
runtime (built by g++, `utils/native_build.py`) on the frontend kernel's
features, as `eval` scores it.  Every artifact must classify all eight
clips (8/8) or the run exits non-zero; the `.tscm` check is never skipped:
a failed build raises `NativeBuildError`.

`--out` defaults to `build/pretrained_torch/`: the shipped `pretrained/`
models, which the parity tests read, stay as they are.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from glob import glob

import numpy as np
import torch

from .. import train
from ..data.synthetic import make_synthetic_dataset
from ..data.wav import load_wav
from ..device import DEFAULT_DEVICE, resolve_device
from ..export.inference_loader import (load_inference_model,
                                       resolve_checkpoint_contract)
from ..export.native_format import export_native
from ..ops.frontend_kernel import MfccFrontend
from ..params import pr
from ..validate_speech_commands import make_predict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_MODELS = ["simple_cnn", "simple_cnn_lite", "simple_gru", "simple_lstm"]
CLASSES = ["background", "left", "right", "up", "down"]
EPOCHS = 40
TRAIN_FLAGS = ("--batch_size", "64", "--bn_momentum", "0.9",
               "--decay_type", "cosine")


def train_one(model_type: str, data_dir: str, out_dir: str, device) -> str:
    """One `train.main` run of the recipe (`EPOCHS` epochs); returns its
    final checkpoint.  The global `pr` is restored after it."""
    log_dir = os.path.join(out_dir, f"logs_{model_type}")
    argv = ["--model_type", model_type, "--train_data_path", data_dir,
            "--classes_path", os.path.join(REPO, "configs",
                                           "direction_classes.txt"),
            "--epochs", str(EPOCHS), *TRAIN_FLAGS, "--log_dir", log_dir,
            "--device", str(device)]
    print("+ train.main", " ".join(argv), flush=True)
    snap = pr.to_dict()
    try:
        train.main(train.build_parser().parse_args(argv))
    finally:
        pr.override(snap)
    return os.path.join(log_dir, "trained_final.npz")


def example_wavs() -> list[str]:
    return sorted(glob(os.path.join(REPO, "example", "*.wav")))


def score_examples(model_path: str, device) -> tuple[np.ndarray, str]:
    """(the example/*.wav clips' scores (8, C), in file-name order; the
    model's format).  A `.npz` loads onto `device` and scores through its
    classifier kernel; every other format scores on the host, on features
    from `device`."""
    predictor, fmt = load_inference_model(model_path, device)
    feature_type = resolve_checkpoint_contract(predictor, fmt,
                                               class_names=CLASSES)
    frontend = MfccFrontend(pr.replace(), feature_type, device)
    predict = make_predict(predictor, fmt)
    audio = torch.stack([
        frontend.plain.pad_audio(torch.from_numpy(load_wav(w)))
        for w in example_wavs()]).to(device)
    with torch.no_grad():
        scores = predict(frontend(audio))
    return scores.float().cpu().numpy(), fmt


def verify_on_examples(model_path: str, device=DEFAULT_DEVICE) -> float:
    """Classify example/*.wav with the artifact; return accuracy."""
    device = resolve_device(device)
    names = [os.path.basename(w) for w in example_wavs()]
    scores, fmt = score_examples(model_path, device)
    preds = np.argmax(scores, axis=-1)
    labels = [CLASSES.index(n.rsplit("_", 1)[0]) for n in names]
    acc = float(np.mean(preds == np.asarray(labels)))
    for name, p in zip(names, preds):
        print(f"  {name}: {CLASSES[p]}")
    print(f"{os.path.basename(model_path)} ({fmt}): example accuracy {acc:.2f}")
    return acc


def check_gate(results: dict) -> None:
    """SystemExit unless every artifact scored 8/8 on the examples."""
    bad = [m for m, r in results.items() if r["npz"] < 1.0 or r["tscm"] < 1.0]
    if bad:
        raise SystemExit(f"models below 100% on example wavs: {bad}")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "pretrained_torch"))
    ap.add_argument("--samples_per_class", type=int, default=80)
    ap.add_argument("--models", nargs="+", default=DEFAULT_MODELS,
                    choices=DEFAULT_MODELS)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Returns {family: {"npz": acc, "tscm": acc, "train_seconds": s}};
    SystemExit when an artifact misses 8/8."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(args.out, exist_ok=True)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "ds")
        make_synthetic_dataset(
            data_dir, CLASSES, samples_per_class=args.samples_per_class, seed=1
        )
        for model_type in args.models:
            t0 = time.perf_counter()
            ckpt = train_one(model_type, data_dir, tmp, device)
            seconds = time.perf_counter() - t0
            print(f"{model_type}: trained in {seconds:.1f} s on {device}")
            dest = os.path.join(args.out, f"direction_{model_type}.npz")
            shutil.copy(ckpt, dest)
            tscm = os.path.join(args.out, f"direction_{model_type}.tscm")
            export_native(dest, tscm)
            snap = pr.to_dict()
            try:
                results[model_type] = {
                    "npz": verify_on_examples(dest, device),
                    "tscm": verify_on_examples(tscm, device),
                    "train_seconds": seconds}
            finally:
                pr.override(snap)

    print(json.dumps(results))
    check_gate(results)
    return results


if __name__ == "__main__":
    main()
