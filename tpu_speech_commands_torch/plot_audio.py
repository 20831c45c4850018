"""Plot the waveform, spectrogram, magnitude and phase of a wav file
(counterpart of `tools/misc/plot_audio.py`, with its flags).

    python -m tpu_speech_commands_torch.plot_audio \\
        --audio_file example/left_1.wav --output_file left_1.png

It runs on the host and needs matplotlib, which the card's machine does
not have: a CPU tool.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .data.wav import load_wav


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--audio_file", required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--n_fft", type=int, default=1024)
    parser.add_argument("--output_file", default=None,
                        help="save PNG instead of showing")
    return parser


def main(argv=None):
    """Returns (audio, stft frequencies, stft times, stft) as plotted."""
    args = build_parser().parse_args(argv)

    import matplotlib

    if args.output_file:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.signal import stft

    audio = load_wav(args.audio_file, args.sample_rate)
    t = np.arange(len(audio)) / args.sample_rate
    f, tt, z = stft(audio, args.sample_rate, nperseg=args.n_fft,
                    noverlap=args.n_fft // 2)

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    axes[0, 0].plot(t, audio, lw=0.5)
    axes[0, 0].set_title("waveform")
    axes[0, 0].set_xlabel("time (s)")
    db = 20 * np.log10(np.abs(z) + 1e-10)
    axes[0, 1].pcolormesh(tt, f, db, shading="gouraud", cmap="magma")
    axes[0, 1].set_title("spectrogram (dB)")
    axes[0, 1].set_ylabel("freq (Hz)")
    spectrum = np.fft.rfft(audio)
    freqs = np.fft.rfftfreq(len(audio), 1 / args.sample_rate)
    axes[1, 0].plot(freqs, np.abs(spectrum), lw=0.5)
    axes[1, 0].set_title("magnitude")
    axes[1, 0].set_xlabel("freq (Hz)")
    axes[1, 1].plot(freqs, np.unwrap(np.angle(spectrum)), lw=0.5)
    axes[1, 1].set_title("phase (unwrapped)")
    axes[1, 1].set_xlabel("freq (Hz)")
    fig.suptitle(os.path.basename(args.audio_file))
    fig.tight_layout()
    if args.output_file:
        fig.savefig(args.output_file, dpi=120)
        print(f"saved {args.output_file}")
    else:
        plt.show()
    plt.close(fig)
    return audio, f, tt, z


if __name__ == "__main__":
    main()
