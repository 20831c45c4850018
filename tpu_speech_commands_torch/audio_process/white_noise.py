"""Generate truncated-normal white-noise wav files
(reference: tools/audio_process/white_noise.py).

Counterpart of `tools/audio_process/white_noise.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.white_noise --help
"""
import argparse
import os

import numpy as np
from scipy.stats import truncnorm

from ._common import save_audio


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--count", type=int, default=1)
    parser.add_argument("--duration", type=float, default=1.0, help="seconds")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--amplitude", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.output_path, exist_ok=True)
    n = int(args.duration * args.sample_rate)
    for i in range(args.count):
        noise = truncnorm.rvs(-3, 3, size=n, random_state=rng) / 3.0
        path = os.path.join(args.output_path, f"white_noise_{i}.wav")
        save_audio(path, (args.amplitude * noise).astype(np.float32),
                   args.sample_rate)
        print(path)


if __name__ == "__main__":
    main()
