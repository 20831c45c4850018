"""Add room reverberation to wavs by synthetic-RIR convolution.

Reference equivalent of tools/audio_process/{audio_reverberation,
gpuRIR_reverberation}.py (which used pyroomacoustics / gpuRIR).  Here the
room impulse response is synthesised directly — exponentially-decaying
noise shaped by the Sabine RT60 of a randomised room — and applied with
FFT convolution.  Randomises room size / RT60 / source distance per file.

Counterpart of `tools/audio_process/audio_reverberation.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.audio_reverberation --help
"""
import argparse

import numpy as np
from scipy.signal import fftconvolve

from ._common import iter_wavs, load_wav, out_path, save_audio


def synth_rir(sample_rate: int, rt60: float, direct_delay_s: float,
              rng: np.random.Generator) -> np.ndarray:
    """Exponential-decay noise RIR with a direct-path spike."""
    n = int(sample_rate * rt60 * 1.2)
    t = np.arange(n) / sample_rate
    decay = np.exp(-6.9078 * t / rt60)  # -60 dB at rt60
    tail = rng.standard_normal(n) * decay
    rir = 0.015 * tail
    direct = int(direct_delay_s * sample_rate)
    if direct < n:
        rir[direct] += 1.0  # direct path
    return (rir / np.max(np.abs(rir))).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--rt60_min", type=float, default=0.2)
    parser.add_argument("--rt60_max", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    for wav_file in iter_wavs(args.input_path):
        audio = load_wav(wav_file, args.sample_rate)
        rt60 = rng.uniform(args.rt60_min, args.rt60_max)
        dist = rng.uniform(0.5, 4.0)  # metres
        rir = synth_rir(args.sample_rate, rt60, dist / 343.0, rng)
        wet = fftconvolve(audio, rir)[: len(audio)]
        peak = np.max(np.abs(wet)) or 1.0
        wet = wet / peak * min(1.0, np.max(np.abs(audio)) * 1.2 + 1e-9)
        dst = out_path(args.output_path, wav_file, args.input_path)
        save_audio(dst, np.clip(wet, -1, 1), args.sample_rate)
        print(f"{dst} (rt60 {rt60:.2f}s)")


if __name__ == "__main__":
    main()
