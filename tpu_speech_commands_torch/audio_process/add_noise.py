"""Mix random noise files into voice wavs at a target SNR.

Re-implementation of the reference tool (tools/audio_process/add_noise.py):
scale = sqrt(P_voice / (10^(snr/10)) / P_noise), noise looped/truncated to
the voice length, random noise file per voice file.

Counterpart of `tools/audio_process/add_noise.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.add_noise --help
"""
import argparse
import random

import numpy as np

from ._common import iter_wavs, load_wav, out_path, save_audio


def add_noise(voice: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    # empty/truncated wavs: tiling an empty noise array is a
    # ZeroDivisionError and np.mean([]) poisons the output with NaN
    if len(voice) == 0 or len(noise) == 0:
        return voice.astype(np.float32)
    if len(noise) < len(voice):
        reps = int(np.ceil(len(voice) / len(noise)))
        noise = np.tile(noise, reps)
    start = random.randint(0, len(noise) - len(voice))
    noise = noise[start : start + len(voice)]
    p_voice = np.mean(voice ** 2)
    p_noise = np.mean(noise ** 2)
    if p_noise <= 0:
        return voice
    scale = np.sqrt(p_voice / (10 ** (snr_db / 10.0)) / p_noise)
    return np.clip(voice + scale * noise, -1.0, 1.0).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--voice_path", required=True, help="voice wav file or dir")
    parser.add_argument("--noise_path", required=True, help="noise wav file or dir")
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--snr", type=float, default=10.0, help="target SNR in dB")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    if args.seed is not None:
        random.seed(args.seed)
    noise_files = list(iter_wavs(args.noise_path))
    assert noise_files, "no noise wavs found"
    for voice_file in iter_wavs(args.voice_path):
        voice = load_wav(voice_file, args.sample_rate)
        noise = load_wav(random.choice(noise_files), args.sample_rate)
        mixed = add_noise(voice, noise, args.snr)
        dst = out_path(args.output_path, voice_file, args.voice_path)
        save_audio(dst, mixed, args.sample_rate)
        print(dst)


if __name__ == "__main__":
    main()
