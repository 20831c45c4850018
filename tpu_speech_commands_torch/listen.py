"""Streaming speech-commands demo: microphone or wav-file replay
(counterpart of the root `listen.py`, with the same flags and `--device`).

    python -m tpu_speech_commands_torch.listen \\
        --model_path pretrained/direction_simple_gru.npz \\
        --classes_path configs/direction_classes.txt \\
        --input_wav example/left_1.wav [--device cpu]

Native `.npz` models run the fused chunk -> scores tick on the card (the
classifier kernel in every tick); `--device cpu` runs the plain versions.
--dump_model re-saves a training checkpoint to a new `.npz` file.
"""
from __future__ import annotations

import argparse
import sys

from .device import DEFAULT_DEVICE
from .streaming import Listener


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--classes_path", type=str, required=True)
    parser.add_argument("--params_path", type=str, default=None)
    parser.add_argument("--chunk_size", type=int, default=1024,
                        help="audio samples between inference")
    parser.add_argument("--sensitivity", type=float, default=0.5)
    parser.add_argument("--trigger_level", type=int, default=3)
    parser.add_argument("--save_dir", type=str, default=None,
                        help="folder to save false positives")
    parser.add_argument("--input_wav", type=str, default=None)
    parser.add_argument("--feature_type", type=str, default=None,
                        choices=["mfcc", "bark"],
                        help="default: the checkpoint's stored frontend")
    parser.add_argument("--chime_path", type=str, default=None,
                        help="activation chime wav (mic mode); default "
                             "assets/activate.wav, alternative "
                             "assets/wozai.wav")
    parser.add_argument("--dump_model", default=False, action="store_true",
                        help="dump training model to inference checkpoint")
    parser.add_argument("--output_model_file", type=str, default=None)
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


def dump_model(model_path: str, output_model_file: str | None) -> str:
    """Re-save a training checkpoint (`.npz`) to `output_model_file`
    (`.npz` appended where missing); returns the path written."""
    if not output_model_file:
        raise ValueError("output model file is not specified")
    if not model_path.endswith(".npz"):
        raise ValueError(
            "--dump_model reads a training checkpoint (.npz); got "
            f"{model_path}"
        )
    from .checkpoints import load_checkpoint
    from .training.checkpoints import save_checkpoint

    print("Dumping out training model to inference model")
    out_file = output_model_file
    if not out_file.endswith(".npz"):
        # np.savez appends .npz silently; make the real path explicit
        out_file += ".npz"
        print(f"note: checkpoint format is .npz — writing {out_file}")
    variables, meta = load_checkpoint(model_path)
    save_checkpoint(out_file, variables, meta)
    return out_file


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.dump_model:
        # dump before constructing the Listener: no stream state is needed
        dump_model(args.model_path, args.output_model_file)
        sys.exit()
    # allowlist against the Listener contract — a denylist would pass any
    # future parser flag straight into Listener.__dict__ unvalidated
    kwargs = {k: v for k, v in vars(args).items() if k in Listener._defaults}
    listener = Listener(**kwargs)
    listener.run()
    return listener


if __name__ == "__main__":
    main()
