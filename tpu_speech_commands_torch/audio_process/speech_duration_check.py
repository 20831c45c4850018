"""Energy-band VAD speech start/end analysis over a dataset
(reference: tools/audio_process/speech_duration_check.py VoiceActivityDetector).

Counterpart of `tools/audio_process/speech_duration_check.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.speech_duration_check --help
"""
import argparse

import numpy as np

from ._common import iter_wavs, load_wav


class VoiceActivityDetector:
    """Frame-energy VAD: a frame is speech when its energy exceeds
    `ratio` x the 20th-percentile frame energy (noise-floor estimate that
    stays robust even when speech covers most of the clip)."""

    def __init__(self, sample_rate=16000, frame_t=0.02, ratio=4.0,
                 hangover_frames=5):
        self.sample_rate = sample_rate
        self.frame = int(frame_t * sample_rate)
        self.ratio = ratio
        self.hangover = hangover_frames

    def detect(self, audio: np.ndarray) -> np.ndarray:
        n = len(audio) // self.frame
        if n == 0:
            return np.zeros(0, bool)
        frames = audio[: n * self.frame].reshape(n, self.frame)
        energy = np.mean(np.square(frames), axis=1)
        floor = np.percentile(energy, 20) + 1e-10
        active = energy > self.ratio * floor
        # hangover smoothing
        out = active.copy()
        run = 0
        for i in range(n):
            if active[i]:
                run = self.hangover
            elif run > 0:
                out[i] = True
                run -= 1
        return out

    def speech_bounds(self, audio: np.ndarray):
        """(start_sec, end_sec) of detected speech, or None."""
        active = self.detect(audio)
        idx = np.flatnonzero(active)
        if len(idx) == 0:
            return None
        return (idx[0] * self.frame / self.sample_rate,
                (idx[-1] + 1) * self.frame / self.sample_rate)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--ratio", type=float, default=4.0)
    args = parser.parse_args(argv)

    vad = VoiceActivityDetector(args.sample_rate, ratio=args.ratio)
    durations = []
    for wav_file in iter_wavs(args.input_path):
        audio = load_wav(wav_file, args.sample_rate)
        bounds = vad.speech_bounds(audio)
        if bounds is None:
            print(f"{wav_file}: no speech detected")
            continue
        start, end = bounds
        durations.append(end - start)
        print(f"{wav_file}: speech {start:.2f}s - {end:.2f}s "
              f"({end - start:.2f}s)")
    if durations:
        d = np.array(durations)
        print(f"speech duration: min {d.min():.2f}s mean {d.mean():.2f}s "
              f"max {d.max():.2f}s over {len(d)} files")


if __name__ == "__main__":
    main()
