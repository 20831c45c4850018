"""Synthesize the activation chime assets (counterpart of
`tools/dev/make_chimes.py`, with its flags; the reference ships
assets/activate.wav + assets/wozai.wav, loaded by its listen.py:294-297).

`activate.wav` is a rising two-note ding; `wozai.wav` is a two-syllable
response chime ("wo-zai": dipping then falling pitch contours, a nod to the
Mandarin tones of the reference's asset name).  Both 16 kHz mono 16-bit
PCM, written by the port's `save_audio`.  Run with --all to write both;
the default writes only wozai.wav.  `--output_dir` defaults to
`build/assets_torch/`, so the committed `assets/*.wav` stay as they are:

    python -m tpu_speech_commands_torch.dev.make_chimes [--all] [--output_dir DIR]
"""
import argparse
import os

import numpy as np

from ..data.wav import save_audio

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RATE = 16000


def _syllable(duration_s, f0_contour, harmonics=(1.0, 0.5, 0.25, 0.12)):
    """One voiced syllable: harmonic stack over an f0 contour with an
    attack/decay envelope."""
    n = int(RATE * duration_s)
    t = np.arange(n) / RATE
    f0 = f0_contour(t / duration_s)
    phase = 2 * np.pi * np.cumsum(f0) / RATE
    out = sum(a * np.sin(k * phase) for k, a in enumerate(harmonics, 1))
    env = np.minimum(t / 0.02, 1.0) * np.exp(-3.0 * t / duration_s)
    return (out * env).astype(np.float32)


def make_wozai() -> np.ndarray:
    """Two syllables: 'wo' (dipping tone: 240->190->240 Hz) then 'zai'
    (falling tone: 340->220 Hz), 60 ms gap."""
    wo = _syllable(0.18, lambda u: 240 - 200 * u * (1 - u))
    gap = np.zeros(int(RATE * 0.06), np.float32)
    zai = _syllable(0.22, lambda u: 340 - 120 * u)
    audio = np.concatenate([wo, gap, zai])
    return 0.6 * audio / np.abs(audio).max()


def make_activate() -> np.ndarray:
    """Rising two-note ding (the shape of the committed activate.wav)."""
    a = _syllable(0.18, lambda u: np.full_like(u, 660.0),
                  harmonics=(1.0, 0.3))
    b = _syllable(0.25, lambda u: np.full_like(u, 880.0),
                  harmonics=(1.0, 0.3))
    audio = np.concatenate([a, b])
    return 0.6 * audio / np.abs(audio).max()


def main(argv=None):
    """Returns the paths written."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output_dir", default=os.path.join(
        REPO, "build", "assets_torch"))
    parser.add_argument("--all", action="store_true",
                        help="also write activate.wav")
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    targets = {"wozai.wav": make_wozai}
    if args.all:
        targets["activate.wav"] = make_activate
    written = []
    for name, fn in targets.items():
        path = os.path.join(args.output_dir, name)
        save_audio(path, fn(), RATE)
        print(path)
        written.append(path)
    return written


if __name__ == "__main__":
    main()
