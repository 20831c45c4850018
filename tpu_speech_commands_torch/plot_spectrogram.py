"""Plot the mel spectrogram and the features the model sees, under the
active `pr` params (counterpart of `tools/misc/plot_spectrogram.py`, with
its flags), from the float64 oracle `frontend/numpy_ref.py`.

    python -m tpu_speech_commands_torch.plot_spectrogram \\
        --audio_file example/left_1.wav --output_file left_1.png

It runs on the host and needs matplotlib, which the card's machine does
not have: a CPU tool.
"""
from __future__ import annotations

import argparse
import os

from .data.wav import load_wav
from .frontend import numpy_ref
from .params import inject_params, pr


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--audio_file", required=True)
    parser.add_argument("--params_path", default=None)
    parser.add_argument("--feature_type", default="mfcc",
                        choices=["mfcc", "bark"])
    parser.add_argument("--output_file", default=None)
    return parser


def main(argv=None):
    """Returns (log-mel spectrogram, features) as plotted."""
    args = build_parser().parse_args(argv)
    if args.params_path:
        inject_params(args.params_path)

    import matplotlib

    if args.output_file:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    audio = load_wav(args.audio_file, pr.sample_rate)
    feats = numpy_ref.audio_to_feature(audio, pr, frontend=args.feature_type)
    mels, _ = numpy_ref.mel_spec(
        audio[: pr.max_samples], pr.sample_rate,
        (pr.window_samples, pr.hop_samples), pr.n_fft, pr.n_filt)

    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    im0 = axes[0].imshow(mels.T, aspect="auto", origin="lower", cmap="magma")
    axes[0].set_title("log-mel spectrogram")
    axes[0].set_xlabel("frame")
    axes[0].set_ylabel("mel band")
    fig.colorbar(im0, ax=axes[0])
    im1 = axes[1].imshow(feats.T, aspect="auto", origin="lower", cmap="magma")
    axes[1].set_title(f"{args.feature_type} features (model input)")
    axes[1].set_xlabel("frame")
    axes[1].set_ylabel("coefficient")
    fig.colorbar(im1, ax=axes[1])
    fig.suptitle(os.path.basename(args.audio_file))
    fig.tight_layout()
    if args.output_file:
        fig.savefig(args.output_file, dpi=120)
        print(f"saved {args.output_file}")
    else:
        plt.show()
    plt.close(fig)
    return mels, feats


if __name__ == "__main__":
    main()
