"""Single-file / directory prediction with top-k scores and latency timing
(counterpart of `tools/evaluation/validate_speech_commands.py`, with its
flags and `--device`).

    python -m tpu_speech_commands_torch.validate_speech_commands \\
        --model_path pretrained/direction_simple_gru.npz \\
        --audio_path example --classes_path configs/direction_classes.txt \\
        --top_k 3 --loop_count 100 [--device cpu]

Loads any format `load_inference_model` takes, makes each wav's features
through `ops.MfccFrontend` (the frontend kernel on the card where the
config's route has one, else the plain chain, which the JAX tool's XLA
`Frontend` is the counterpart of), prints the top-k class scores and the
average time of `--loop_count` predictions.  A native `.npz` scores
through its classifier kernel on the card (`serving.make_classifier`);
every other format scores on the host.  On the card the timed loop sits
between two `torch.cuda.synchronize()` calls, so the printed ms covers the
device work.  `--device cpu` runs the plain versions.
"""
from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np
import torch

from .data.wav import load_wav
from .device import DEFAULT_DEVICE, resolve_device
from .export.inference_loader import (load_inference_model,
                                      resolve_checkpoint_contract)
from .models import features_to_input, score_fn
from .ops.frontend_kernel import MfccFrontend
from .params import inject_params, pr
from .serving import make_classifier
from .utils import get_classes


def handle_prediction(scores, class_names, top_k, wav_path, output_path=None):
    """Print the top-k classes and scores (and write them to
    <output_path>/<wav name>.txt); returns [(class, score), ...]."""
    order = np.argsort(scores)[::-1][:top_k]
    lines = [f"{wav_path}:"]
    for idx in order:
        lines.append(f"  {class_names[idx]}: {scores[idx]:.6f}")
    text = "\n".join(lines)
    print(text)
    if output_path:
        os.makedirs(output_path, exist_ok=True)
        name = os.path.splitext(os.path.basename(wav_path))[0]
        out_file = os.path.join(output_path, name + ".txt")
        with open(out_file, "w") as f:
            f.write(text + "\n")
    return [(class_names[i], float(scores[i])) for i in order]


def make_predict(predictor, model_format: str):
    """features (1, T, F) on the frontend's device -> (1, C) scores: the
    classifier kernel for a native checkpoint, else the format's host
    runtime."""
    if model_format == "NATIVE":
        classifier, _ = make_classifier(predictor.model, predictor.model_type)

        def predict(feats):
            with torch.no_grad():
                return score_fn(classifier(
                    features_to_input(feats, predictor.model_type)))

        return predict
    return lambda feats: torch.as_tensor(predictor(feats.cpu().numpy()))


def validate(model_path, wav_paths, class_names, top_k=1, loop_count=1,
             feature_type=None, output_path=None, device=DEFAULT_DEVICE):
    device = resolve_device(device)
    predictor, model_format = load_inference_model(model_path, device)
    print(f"Loaded {model_format} model")
    feature_type = resolve_checkpoint_contract(
        predictor, model_format, class_names=class_names,
        feature_type=feature_type)
    frontend = MfccFrontend(pr, feature_type, device)
    predict = make_predict(predictor, model_format)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = []
    for wav_path in wav_paths:
        audio = torch.from_numpy(load_wav(wav_path, pr.sample_rate)
                                 .astype(np.float32))
        audio = frontend.plain.pad_audio(audio)[None].to(device)
        with torch.no_grad():
            feats = frontend(audio)
        scores = predict(feats)[0]  # warm-up
        sync()
        start = time.perf_counter()
        for _ in range(loop_count):
            scores = predict(feats)[0]
        sync()
        elapsed = time.perf_counter() - start
        print(f"Average Inference time: "
              f"{elapsed / max(loop_count, 1) * 1000:.4f}ms")
        results.append(handle_prediction(
            scores.float().cpu().numpy(), class_names, top_k, wav_path,
            output_path))
    return results


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--audio_path", type=str, required=True,
                        help="wav file or directory of wavs")
    parser.add_argument("--classes_path", type=str, required=True)
    parser.add_argument("--params_path", type=str, default=None)
    parser.add_argument("--top_k", type=int, default=1)
    parser.add_argument("--loop_count", type=int, default=1)
    parser.add_argument("--feature_type", type=str, default=None,
                        choices=["mfcc", "bark"])
    parser.add_argument("--output_path", type=str, default=None)
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.params_path:
        inject_params(args.params_path)
    class_names = get_classes(args.classes_path)
    if os.path.isdir(args.audio_path):
        wav_paths = sorted(glob(os.path.join(args.audio_path, "*.wav")))
    else:
        wav_paths = [args.audio_path]
    return validate(args.model_path, wav_paths, class_names, args.top_k,
                    args.loop_count, args.feature_type, args.output_path,
                    args.device)


if __name__ == "__main__":
    main()
