"""Dump a training checkpoint to a self-describing inference checkpoint
(counterpart of `tools/misc/dump_inference_model.py`, with its flags): any
`.npz` checkpoint -> an `.npz` with complete metadata (model_type,
num_classes, classes, params), ready for eval, listen, validate and export.

    python -m tpu_speech_commands_torch.dump_inference_model \\
        --checkpoint logs/000/trained_final.npz --output_file model.npz \\
        [--model_type simple_gru] [--classes_path classes.txt] \\
        [--params_path params.json]

It reads and writes on the host (numpy only): for the same checkpoint its
output holds the JAX tool's keys, arrays and metadata.
"""
from __future__ import annotations

import argparse

from .checkpoints import load_checkpoint
from .params import inject_params, pr
from .training.checkpoints import save_checkpoint
from .utils import get_classes


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--model_type", default=None,
                        help="override/assign model_type metadata")
    parser.add_argument("--classes_path", default=None)
    parser.add_argument("--params_path", default=None)
    return parser


def main(argv=None) -> dict:
    """Returns the metadata written."""
    args = build_parser().parse_args(argv)
    if args.params_path:
        inject_params(args.params_path)
    variables, meta = load_checkpoint(args.checkpoint)
    if args.model_type:
        meta["model_type"] = args.model_type
    if args.classes_path:
        classes = get_classes(args.classes_path)
        meta["classes"] = classes
        meta["num_classes"] = len(classes)
    if args.params_path:
        # an explicit --params_path repairs the stored params; setdefault
        # would keep the checkpoint's old ones
        meta["params"] = pr.to_dict()
    else:
        meta.setdefault("params", pr.to_dict())
    if not meta.get("model_type"):
        raise ValueError("model_type metadata required (--model_type)")
    if not meta.get("num_classes"):
        raise ValueError("num_classes metadata required (--classes_path)")
    save_checkpoint(args.output_file, variables, meta)
    print(f"dumped inference checkpoint to {args.output_file}")
    return meta


if __name__ == "__main__":
    main()
