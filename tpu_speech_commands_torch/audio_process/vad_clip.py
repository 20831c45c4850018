"""Extract voice clips from long recordings.

Two detectors (reference: tools/audio_process/vad_clip.py, which scored
1-second frames with a learned Conv-VAD Keras model):

- --model_path: the learned path.  Any checkpoint trained by this
  framework works as the VAD scorer: speech score = 1 - P(background)
  (class 0 is 'background' by the class-list contract), evaluated on
  1-second frames at 1-second hops — the reference's exact framing.  All
  frames of a file are scored in ONE batched forward (device-friendly),
  then segmented with the reference's transition semantics: consecutive
  voiced frames accumulate and are written when voice ends, named
  `{stem}_{endtime}.wav` (a segment still active at end-of-file is
  flushed too).  Thresholding matches the reference default 0.7.
- default: energy-band VAD (speech_duration_check.VoiceActivityDetector)
  with clip padding — no model needed.

In the port the model path scores through `serving.make_batch_scorer` on
`--device` (the card unless `cpu` is passed): the frames of a file go
through the frontend kernel, then the GRU, LSTM or CNN classifier kernel,
in one batch.  Without CUDA, `--device cuda` raises; nothing falls back to
the CPU.

Counterpart of `tools/audio_process/vad_clip.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.vad_clip --help
"""
import argparse
import os

import numpy as np

from ..device import DEFAULT_DEVICE
from ._common import iter_wavs, load_wav, save_audio
from .speech_duration_check import VoiceActivityDetector

EXAMPLE_WORD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "example", "left_1.wav")


def model_scores(audio: np.ndarray, scorer, max_samples: int,
                 sample_rate: int) -> np.ndarray:
    """Speech score (1 - P(background)) per 1-second frame, one batch."""
    n_frames = len(audio) // sample_rate
    if n_frames == 0:
        return np.zeros(0, np.float32)
    frames = audio[: n_frames * sample_rate].reshape(n_frames, sample_rate)
    if sample_rate < max_samples:  # left-pad: command-at-tail convention
        frames = np.pad(frames, ((0, 0), (max_samples - sample_rate, 0)))
    else:
        frames = frames[:, -max_samples:]
    scores = scorer(frames.astype(np.float32)).float().cpu().numpy()
    return 1.0 - scores[:, 0]


def noise_word_noise(path: str, word_wav: str = EXAMPLE_WORD,
                     seed: int = 5) -> np.ndarray:
    """Write a check recording for the learned path to `path` and return
    it: 2 s of noise (seed `seed`), the last second of `word_wav`, 2 s of
    noise, at 16 kHz.  With the shipped simple_gru checkpoint only frame 2
    (the word's second) scores at or above the default threshold."""
    rng = np.random.default_rng(seed)
    word = load_wav(word_wav, 16000)
    audio = np.concatenate([
        0.002 * rng.standard_normal(32000), word[-16000:],
        0.002 * rng.standard_normal(32000),
    ]).astype(np.float32)
    save_audio(path, audio, 16000)
    return audio


def clip_with_model(wav_file, scorer, max_samples, threshold, output_path,
                    sample_rate):
    audio = load_wav(wav_file, sample_rate)
    speech = model_scores(audio, scorer, max_samples, sample_rate)
    stem = os.path.splitext(os.path.basename(wav_file))[0]
    written = []
    seg_start = None
    for i, s in enumerate(speech):
        if s >= threshold:
            if seg_start is None:
                seg_start = i
        elif seg_start is not None:
            dst = os.path.join(output_path, f"{stem}_{i}.wav")
            save_audio(dst, audio[seg_start * sample_rate: i * sample_rate],
                       sample_rate)
            written.append(dst)
            seg_start = None
    if seg_start is not None:  # flush a segment active at end of file
        end = len(speech)
        dst = os.path.join(output_path, f"{stem}_{end}.wav")
        save_audio(dst, audio[seg_start * sample_rate: end * sample_rate],
                   sample_rate)
        written.append(dst)
    return written


def main(argv=None):
    """Returns the clip paths written, in order."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--model_path", default=None,
                        help="checkpoint (.npz) used as learned VAD; "
                             "speech score = 1 - P(background)")
    parser.add_argument("--score_threshold", type=float, default=0.7,
                        help="speech-score threshold for the model path. "
                             "default=%(default)s")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="the model path's device: cuda (default) or cpu")
    parser.add_argument("--min_clip_t", type=float, default=0.3)
    parser.add_argument("--pad_t", type=float, default=0.1,
                        help="context padding around each clip (seconds; "
                             "energy path only)")
    args = parser.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)

    if args.model_path:
        from ..serving import make_batch_scorer

        scorer = make_batch_scorer(args.model_path, args.device)
        max_samples = scorer.params.max_samples
        written = []
        for wav_file in iter_wavs(args.input_path):
            for dst in clip_with_model(
                wav_file, scorer, max_samples, args.score_threshold,
                args.output_path, args.sample_rate,
            ):
                print(dst)
                written.append(dst)
        print("done")
        return written

    vad = VoiceActivityDetector(args.sample_rate)
    written = []
    for wav_file in iter_wavs(args.input_path):
        audio = load_wav(wav_file, args.sample_rate)
        active = vad.detect(audio)
        stem = os.path.splitext(os.path.basename(wav_file))[0]
        # contiguous active runs -> clips
        clip_idx = 0
        i = 0
        n = len(active)
        while i < n:
            if not active[i]:
                i += 1
                continue
            j = i
            while j < n and active[j]:
                j += 1
            start = max(0, int(i * vad.frame - args.pad_t * args.sample_rate))
            end = min(len(audio), int(j * vad.frame + args.pad_t * args.sample_rate))
            if (end - start) / args.sample_rate >= args.min_clip_t:
                dst = os.path.join(args.output_path, f"{stem}_clip{clip_idx}.wav")
                save_audio(dst, audio[start:end], args.sample_rate)
                print(dst)
                written.append(dst)
                clip_idx += 1
            i = j
    print("done")
    return written


if __name__ == "__main__":
    main()
