"""Overlay voice and noise wavs with an RMS-based volume ratio
(reference: tools/audio_process/wav_merge.py).

Counterpart of `tools/audio_process/wav_merge.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.wav_merge --help
"""
import argparse

import numpy as np

from ._common import iter_wavs, load_wav, out_path, save_audio


def rms(x):
    return float(np.sqrt(np.mean(np.square(x)))) or 1e-9


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--voice_path", required=True)
    parser.add_argument("--noise_path", required=True, help="single noise wav")
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--volume_ratio", type=float, default=0.3,
                        help="noise RMS relative to voice RMS")
    parser.add_argument("--sample_rate", type=int, default=16000)
    args = parser.parse_args(argv)

    noise = load_wav(args.noise_path, args.sample_rate)
    for voice_file in iter_wavs(args.voice_path):
        voice = load_wav(voice_file, args.sample_rate)
        if len(voice) == 0 or len(noise) == 0:
            print(f"skip empty wav: {voice_file}")
            continue
        n = noise
        if len(n) < len(voice):
            n = np.tile(n, int(np.ceil(len(voice) / len(n))))
        n = n[: len(voice)]
        scale = args.volume_ratio * rms(voice) / rms(n)
        merged = np.clip(voice + scale * n, -1, 1).astype(np.float32)
        dst = out_path(args.output_path, voice_file, args.voice_path)
        save_audio(dst, merged, args.sample_rate)
        print(dst)


if __name__ == "__main__":
    main()
