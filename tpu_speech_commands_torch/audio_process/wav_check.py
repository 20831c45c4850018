"""Validate wav format (rate/channels/depth) and print a duration histogram
(reference: tools/audio_process/wav_check.py).

Counterpart of `tools/audio_process/wav_check.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.wav_check --help
"""
import argparse
import wave

import numpy as np

from ._common import iter_wavs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--channels", type=int, default=1)
    parser.add_argument("--sample_depth", type=int, default=2)
    args = parser.parse_args(argv)

    durations = []
    bad = 0
    for wav_file in iter_wavs(args.input_path):
        try:
            with wave.open(wav_file, "rb") as wf:
                ok = (
                    wf.getframerate() == args.sample_rate
                    and wf.getnchannels() == args.channels
                    and wf.getsampwidth() == args.sample_depth
                )
                durations.append(wf.getnframes() / wf.getframerate())
        except Exception as e:
            ok = False
            print(f"UNREADABLE {wav_file}: {e}")
        if not ok:
            bad += 1
            print(f"BAD FORMAT {wav_file}")
    if durations:
        d = np.array(durations)
        print(f"{len(d)} files, {bad} bad format")
        print(f"duration: min {d.min():.2f}s  mean {d.mean():.2f}s  "
              f"max {d.max():.2f}s")
        hist, edges = np.histogram(d, bins=10)
        for count, lo, hi in zip(hist, edges, edges[1:]):
            print(f"  {lo:5.2f}-{hi:5.2f}s: {'#' * max(1, int(40 * count / max(hist.max(), 1))) if count else ''} {count}")


if __name__ == "__main__":
    main()
