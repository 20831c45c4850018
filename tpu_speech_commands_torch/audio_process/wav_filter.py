"""Butterworth low/high/band-pass filtering of wav files
(reference: tools/audio_process/wav_filter.py).

Counterpart of `tools/audio_process/wav_filter.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.wav_filter --help
"""
import argparse

import numpy as np
from scipy.signal import butter, lfilter

from ._common import iter_wavs, load_wav, out_path, save_audio


def butter_filter(audio, sample_rate, filter_type, cutoff, cutoff_high=None,
                  order=5):
    nyq = 0.5 * sample_rate
    if filter_type == "bandpass":
        assert cutoff_high is not None, "bandpass needs --cutoff_high"
        b, a = butter(order, [cutoff / nyq, cutoff_high / nyq], btype="band")
    else:
        b, a = butter(order, cutoff / nyq, btype={"lowpass": "low",
                                                  "highpass": "high"}[filter_type])
    return lfilter(b, a, audio).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--filter_type", default="lowpass",
                        choices=["lowpass", "highpass", "bandpass"])
    parser.add_argument("--cutoff", type=float, required=True, help="Hz")
    parser.add_argument("--cutoff_high", type=float, default=None,
                        help="upper cutoff for bandpass (Hz)")
    parser.add_argument("--order", type=int, default=5)
    parser.add_argument("--sample_rate", type=int, default=16000)
    args = parser.parse_args(argv)

    for wav_file in iter_wavs(args.input_path):
        audio = load_wav(wav_file, args.sample_rate)
        filtered = butter_filter(audio, args.sample_rate, args.filter_type,
                                 args.cutoff, args.cutoff_high, args.order)
        dst = out_path(args.output_path, wav_file, args.input_path)
        save_audio(dst, np.clip(filtered, -1, 1), args.sample_rate)
        print(dst)


if __name__ == "__main__":
    main()
