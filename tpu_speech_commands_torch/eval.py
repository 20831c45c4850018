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
import os
import time

from .data.dataset import get_dataset
from .device import DEFAULT_DEVICE, resolve_device
from .evaluation import evaluate_accuracy
from .export.inference_loader import load_native
from .ops.frontend_kernel import MfccFrontend
from .params import inject_params, pr
from .serving import make_classifier
from .utils import ensure_background_first, get_classes

_EXTERNAL = ((".tflite", "TFLite"), (".h5", "Keras h5"), (".keras", "Keras"),
             (".onnx", "ONNX"), (".tscm", "native .tscm"), (".pb", "frozen pb"),
             (".mnn", "MNN"))


def external_format(model_path: str) -> str | None:
    """The name of a model format the port cannot load yet, or None for a
    native `.npz`."""
    if model_path.endswith(".npz"):
        return None
    for suffix, name in _EXTERNAL:
        if model_path.endswith(suffix):
            return name
    return "SavedModel" if os.path.isdir(model_path) else "unknown"


def resolve_feature_type(meta: dict, num_classes: int, class_names,
                         feature_type: str | None, warn=print) -> str:
    """The checkpoint contract of the JAX evaluator: the feature type from
    the checkpoint unless the flag names one (a contradiction warns), and a
    class count that must match the model's head."""
    meta_ft = meta.get("feature_type")
    if feature_type is None:
        feature_type = meta_ft or "mfcc"
    elif meta_ft and feature_type != meta_ft:
        warn(f"WARNING: --feature_type {feature_type} overrides the "
             f"checkpoint's stored feature_type={meta_ft}; scores will be "
             "meaningless unless this is intentional.")
    if num_classes is not None and num_classes != len(class_names):
        raise ValueError(f"classes file has {len(class_names)} entries but the "
                         f"model predicts {num_classes} classes")
    stored = meta.get("classes")
    if stored and list(stored) != list(class_names):
        warn("WARNING: classes file differs from the checkpoint's stored "
             f"class list {list(stored)}; labels may be misattributed.")
    return feature_type


def main(args):
    """Returns (accuracy, confusion matrix)."""
    fmt = external_format(args.model_path)
    if fmt is not None:
        raise ValueError(
            f"{args.model_path}: the {fmt} format is not ported to "
            "tpu_speech_commands_torch yet (queued in ROADMAP.md); the port "
            "evaluates native .npz checkpoints")
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
