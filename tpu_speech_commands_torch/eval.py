"""Evaluate a native `.npz` speech-commands classifier on a test dataset
(counterpart of the root `eval.py`, with the same flags and `--device`).

    python -m tpu_speech_commands_torch.eval --model_path m.npz \\
        --dataset_path ds --classes_path classes.txt [--device cpu]

On the card (the default) the features come from the frontend kernel and
the scores from the classifier kernel that serving uses; accuracy and the
confusion matrix accumulate on the card.  `--device cpu` runs the plain
versions.  The external formats of the JAX evaluator (tflite, h5 / keras,
SavedModel, onnx, .tscm, .pb) are not ported yet: they raise ValueError.
"""
from __future__ import annotations

import argparse
import time

from .data.dataset import get_dataset
from .device import DEFAULT_DEVICE, resolve_device
from .evaluation import evaluate_accuracy
from .export.inference_loader import (load_native, require_native,
                                      resolve_feature_type)
from .ops.frontend_kernel import MfccFrontend
from .params import inject_params, pr
from .serving import make_classifier
from .utils import ensure_background_first, get_classes


def main(args):
    """Returns (accuracy, confusion matrix)."""
    require_native(args.model_path)
    device = resolve_device(args.device)
    class_names = get_classes(args.classes_path)
    ensure_background_first(class_names)

    # load FIRST (a native checkpoint restores its stored params), then an
    # explicit --params_path wins on top
    predictor = load_native(args.model_path, device)
    print(f"Loaded NATIVE model from {args.model_path}")
    if args.params_path:
        inject_params(args.params_path)
    feature_type = resolve_feature_type(predictor.meta, predictor.num_classes,
                                        class_names, args.feature_type)

    frontend = MfccFrontend(pr, feature_type, device)
    ds = get_dataset(args.dataset_path, class_names, frontend=frontend,
                     device=device)
    classifier, _ = make_classifier(predictor.model, predictor.model_type)
    start = time.time()
    accuracy, confusion = evaluate_accuracy(
        classifier, ds, predictor.model_type, class_names,
        batch_size=args.batch_size, device=device,
        output_path=args.output_path)
    print("Evaluation time cost: {:.6f}s".format(time.time() - start))
    return accuracy, confusion


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--classes_path", type=str, required=True)
    parser.add_argument("--params_path", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--feature_type", type=str, default=None,
                        choices=["mfcc", "bark"],
                        help="default: the checkpoint's stored frontend")
    parser.add_argument("--output_path", type=str, default="result")
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
