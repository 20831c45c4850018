"""Evaluate a speech-commands classifier (native `.npz`, `.tscm`, onnx,
tflite, h5 / keras, SavedModel, pb) on a test dataset (counterpart of the
root `eval.py`, with the same flags and `--device`).

    python -m tpu_speech_commands_torch.eval --model_path m.npz \\
        --dataset_path ds --classes_path classes.txt [--device cpu]

On the card (the default) the features come from the frontend kernel for
every format.  A native checkpoint's scores come from the classifier kernel
that serving uses, with accuracy and the confusion matrix accumulated on
the card; an exported model's come from its host runtime (the C++ runtime
for `.tscm`, the numpy executor or onnxruntime for onnx, TensorFlow for
the rest), counted on the host, as in the JAX evaluator.  `--device cpu`
runs the plain versions.  `--num_devices N` splits a native checkpoint's
batches over N devices on the 'data' axis (`evaluate_accuracy(...,
mesh=)`, one process): N visible cards (ValueError, the JAX one, when
there are fewer), or N shards on the CPU with `--device cpu`.
"""
from __future__ import annotations

import argparse
import time

from .data.dataset import get_dataset
from .device import DEFAULT_DEVICE, resolve_device
from .evaluation import (evaluate_accuracy, evaluate_with_predict_fn,
                         plot_confusion_matrix)
from .export.inference_loader import (load_inference_model,
                                      resolve_checkpoint_contract)
from .ops.frontend_kernel import MfccFrontend
from .params import inject_params, pr
from .parallel import make_mesh
from .serving import make_classifier
from .utils import ensure_background_first, get_classes


def main(args):
    """Returns (accuracy, confusion matrix)."""
    device = resolve_device(args.device)
    mesh = None
    if args.num_devices is not None:
        mesh = make_mesh(n_data=args.num_devices,
                         devices=[device] * args.num_devices
                         if device.type == "cpu" else None)
        device = mesh.batch_devices()[0]
    class_names = get_classes(args.classes_path)
    ensure_background_first(class_names)

    # load FIRST (a native checkpoint restores its stored params), then an
    # explicit --params_path wins on top
    predictor, model_format = load_inference_model(args.model_path, device)
    print(f"Loaded {model_format} model from {args.model_path}")
    if args.params_path:
        inject_params(args.params_path)
    feature_type = resolve_checkpoint_contract(
        predictor, model_format, class_names=class_names,
        feature_type=args.feature_type)

    frontend = MfccFrontend(pr, feature_type, device)
    ds = get_dataset(args.dataset_path, class_names, frontend=frontend,
                     device=device)
    start = time.time()
    if model_format == "NATIVE":
        classifier, _ = make_classifier(predictor.model, predictor.model_type)
        accuracy, confusion = evaluate_accuracy(
            classifier, ds, predictor.model_type, class_names,
            batch_size=args.batch_size, device=device,
            output_path=args.output_path, mesh=mesh)
    else:
        accuracy, confusion = evaluate_with_predict_fn(
            predictor, ds, class_names, args.batch_size)
        print(f"Eval on {len(ds)} samples: accuracy {accuracy:.4f}")
        plot_confusion_matrix(confusion, class_names, args.output_path)
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
                        help="default: the checkpoint's stored frontend "
                             "(mfcc for external formats)")
    parser.add_argument("--output_path", type=str, default="result")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="split a native checkpoint's batches over this "
                             "many devices (default: one)")
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
