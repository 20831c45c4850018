"""Filter out (or list) silent wav files by average energy per second
(reference: tools/audio_process/silent_check.py).

Counterpart of `tools/audio_process/silent_check.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.silent_check --help
"""
import argparse
import os

import numpy as np

from ._common import iter_wavs, load_wav


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--threshold", type=float, default=1e-4,
                        help="mean square energy per second threshold")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--delete", action="store_true",
                        help="delete silent files instead of listing")
    args = parser.parse_args(argv)

    silent = 0
    total = 0
    for wav_file in iter_wavs(args.input_path):
        total += 1
        audio = load_wav(wav_file, args.sample_rate)
        energy = float(np.mean(np.square(audio)))
        if energy < args.threshold:
            silent += 1
            print(f"SILENT {wav_file} (energy {energy:.3e})")
            if args.delete:
                os.remove(wav_file)
    print(f"{silent}/{total} silent files" + (" deleted" if args.delete else ""))


if __name__ == "__main__":
    main()
