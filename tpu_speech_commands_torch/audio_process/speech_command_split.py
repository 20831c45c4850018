"""VAD-based speech-command segment extraction.

Generalisation of the reference's wake-word splitter
(its `tools/audio_process/roborock_speech_command_split.py`):
long recordings of the form "<wake word> ... <command>" are segmented with
an energy-band voice-activity detector, and the command segment (by
default the SECOND detected segment, the reference behaviour) is written
out with configurable head/tail slack; recordings where the expected
number of segments is not found are copied to a backup directory for
manual review.

Differences from the reference: the VAD is a vectorised rfft band-energy
ratio (the reference loops a python dict per FFT bin), webrtcvad is not
required (not shipped here), and the segment index / expected count /
slack are CLI-configurable instead of hardcoded.

    # print detected segments of one file
    python -m tpu_speech_commands_torch.audio_process.speech_command_split \\
        --wav_path rec.wav

    # split a directory (reference semantics: 2 segments, keep the 2nd)
    python -m tpu_speech_commands_torch.audio_process.speech_command_split \\
        --wav_path raw/ --split_output_path out/ --backup_path failed/

Counterpart of `tools/audio_process/speech_command_split.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.speech_command_split --help
"""
import argparse
import glob
import os
from shutil import copy

import numpy as np

from ._common import load_wav, save_audio


def band_energy_vad(
    audio: np.ndarray,
    sample_rate: int,
    window_t: float = 0.02,
    hop_t: float = 0.01,
    smooth_t: float = 0.5,
    band=(300.0, 3000.0),
    ratio_threshold: float = 0.6,
    abs_floor: float = 1e-6,
) -> np.ndarray:
    """Per-hop speech flags from the voice-band / total energy ratio.

    A 20 ms window is "speech" when the 300-3000 Hz band holds more than
    `ratio_threshold` of its spectral energy (reference thresholds,
    roborock_speech_command_split.py:21-26) AND carries non-negligible
    absolute energy (guards silence, where the ratio is meaningless).
    Flags are median-smoothed over `smooth_t` seconds.
    """
    win = max(1, int(sample_rate * window_t))
    hop = max(1, int(sample_rate * hop_t))
    n_frames = max(0, 1 + (len(audio) - win) // hop)
    if n_frames == 0:
        return np.zeros(0, bool)
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = audio[idx]

    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    freqs = np.fft.rfftfreq(win, 1.0 / sample_rate)
    in_band = (freqs > band[0]) & (freqs < band[1])
    total = spec[:, 1:].sum(-1)  # DC excluded, like the reference
    voiced = spec[:, in_band].sum(-1)
    ratio = voiced / np.maximum(total, 1e-20)
    flags = (ratio > ratio_threshold) & (total / win > abs_floor)

    k = int(smooth_t / hop_t)
    k = k - 1 if k % 2 == 0 else k
    if k >= 3:
        pad = k // 2
        padded = np.pad(flags.astype(np.float32), pad, mode="edge")
        windows = np.lib.stride_tricks.sliding_window_view(padded, k)
        flags = np.median(windows, axis=-1) > 0.5
    return flags


def flags_to_segments(flags: np.ndarray, hop_t: float = 0.01,
                      min_duration: float = 0.1):
    """Speech flag runs -> [(begin_seconds, end_seconds), ...]."""
    segments = []
    start = None
    for i, f in enumerate(np.append(flags, False)):
        if f and start is None:
            start = i
        elif not f and start is not None:
            begin, end = start * hop_t, i * hop_t
            if end - begin >= min_duration:
                segments.append((begin, end))
            start = None
    return segments


def detect_segments(audio: np.ndarray, sample_rate: int, **vad_kwargs):
    hop_t = vad_kwargs.get("hop_t", 0.01)
    flags = band_energy_vad(audio, sample_rate, **vad_kwargs)
    return flags_to_segments(flags, hop_t=hop_t)


def split_file(wav_file, output_dir, expect_segments, segment_index,
               head_s, tail_s, sample_rate):
    audio = load_wav(wav_file, sample_rate=sample_rate)
    segments = detect_segments(audio, sample_rate)
    if len(segments) != expect_segments:
        return None, segments
    begin, end = segments[segment_index]
    lo = max(0, int(sample_rate * (begin - head_s)))
    hi = min(len(audio), int(sample_rate * (end + tail_s)))
    out_file = os.path.join(output_dir, os.path.basename(wav_file))
    save_audio(out_file, audio[lo:hi], sample_rate=sample_rate)
    return out_file, segments


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--wav_path", required=True,
                        help="wav file (print segments) or directory (split)")
    parser.add_argument("--split_output_path", default=None,
                        help="output dir for extracted command segments")
    parser.add_argument("--backup_path", default=None,
                        help="dir for files where detection failed")
    parser.add_argument("--expect_segments", type=int, default=2,
                        help="required segment count (wake word + command)")
    parser.add_argument("--segment_index", type=int, default=1,
                        help="which segment is the command (default: second)")
    parser.add_argument("--head_time", type=float, default=1.0,
                        help="seconds of context kept before the segment")
    parser.add_argument("--tail_time", type=float, default=0.5,
                        help="seconds of context kept after the segment")
    parser.add_argument("--sample_rate", type=int, default=16000)
    args = parser.parse_args(argv)
    if not 0 <= args.segment_index < args.expect_segments:
        parser.error(
            f"--segment_index {args.segment_index} out of range for "
            f"--expect_segments {args.expect_segments}"
        )

    if os.path.isfile(args.wav_path):
        audio = load_wav(args.wav_path, sample_rate=args.sample_rate)
        segments = detect_segments(audio, args.sample_rate)
        print(f"speech sections: "
              f"{[{'speech_begin': b, 'speech_end': e} for b, e in segments]}")
        return

    assert args.split_output_path and args.backup_path, (
        "--split_output_path and --backup_path are required in directory mode"
    )
    os.makedirs(args.split_output_path, exist_ok=True)
    os.makedirs(args.backup_path, exist_ok=True)
    wav_files = sorted(glob.glob(os.path.join(args.wav_path, "*.wav")))
    split_count = 0
    for i, wav_file in enumerate(wav_files):
        out, segments = split_file(
            wav_file, args.split_output_path, args.expect_segments,
            args.segment_index, args.head_time, args.tail_time,
            args.sample_rate,
        )
        if out is not None:
            split_count += 1
        else:
            copy(wav_file, args.backup_path)
        print(f"\rsplit speech command: {i + 1}/{len(wav_files)}",
              end="", flush=True)
    print(f"\nnumber of split wav file: {split_count}")


if __name__ == "__main__":
    main()
