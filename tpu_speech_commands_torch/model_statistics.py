"""Print a model's parameter count and FLOPs (counterpart of
`tools/evaluation/model_statistics.py`, with the same flags).

    python -m tpu_speech_commands_torch.model_statistics --model_type simple_gru

The FLOPs are 2 x the multiply-accumulates of the plain forward, counted on
the CPU (`evaluation/statistics.py`).
"""
from __future__ import annotations

import argparse

from .evaluation.statistics import get_model_statistics
from .models.factory import MODEL_TYPES
from .params import inject_params


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_type", type=str, default="simple_cnn",
                        choices=MODEL_TYPES)
    parser.add_argument("--num_classes", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--params_path", type=str, default=None)
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.params_path:
        inject_params(args.params_path)
    stats = get_model_statistics(args.model_type, args.num_classes,
                                 args.batch_size)
    print(f"Model: {stats['model_type']} (batch {stats['batch_size']})")
    print(f"Total params: {stats['params']} ({stats['params_str']})")
    print(f"Total FLOPs:  {stats['flops']:.0f} ({stats['flops_str']})")
    return stats


if __name__ == "__main__":
    main()
