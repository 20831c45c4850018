"""Convert audio files: sample rate / channels / sample bit / loudness /
fixed clip length, wav and raw-PCM inputs.

Full option surface of the reference tool
(its tools/audio_process/audio_convert.py:100-180) without
its librosa/pydub/soundfile stack — stdlib wave + numpy + scipy
polyphase resampling:

- --channel_num: mono mixdown (channel mean) or channel duplication
- --sample_rate: polyphase resample
- --sample_bit: 8/16/24/32-bit integer PCM output encoding
- --loudness: normalize to a target dBFS (RMS relative to full scale)
- --clip_length ms: clip from the TAIL, or pad at the HEAD with silence
  (or truncated-normal white noise via --fill_white_noise, amplitude in
  the reference's bit-fraction convention) — pad_audio semantics, the
  command sits at the buffer tail
- .pcm/.raw inputs: headerless 16-bit PCM decoded with the given
  --sample_rate/--channel_num
- --target_format wav (native) or mp3 (gated on ffmpeg, like
  mp3_convert.sh)

Counterpart of `tools/audio_process/audio_convert.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.audio_convert --help
"""
import argparse
import os
import shutil
import subprocess
import wave
from glob import glob

import numpy as np

from ._common import iter_wavs, load_wav, out_path


def _write_pcm(path: str, audio: np.ndarray, sample_rate: int,
               sample_bit: int):
    """(n, ch) float in [-1, 1] -> integer PCM wav at sample_bit."""
    audio = np.clip(audio, -1.0, 1.0)
    ch = audio.shape[1]
    if sample_bit == 8:  # 8-bit wav is unsigned
        enc = ((audio * 127.0) + 128.0).astype(np.uint8).tobytes()
    elif sample_bit == 16:
        enc = (audio * np.iinfo(np.int16).max).astype("<i2").tobytes()
    elif sample_bit == 24:
        as32 = (audio * float((1 << 23) - 1)).astype("<i4")
        b = as32.view(np.uint8).reshape(-1, 4)[:, :3]  # little-endian 24
        enc = np.ascontiguousarray(b).tobytes()
    elif sample_bit == 32:
        enc = (audio * float(2 ** 31 - 1)).astype("<i4").tobytes()
    else:
        raise ValueError(f"unsupported sample_bit {sample_bit}")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(ch)
        wf.setsampwidth(sample_bit // 8)
        wf.setframerate(sample_rate)
        wf.writeframes(enc)


def white_noise(n: int, sample_bit: int, amplitude: float,
                rng: np.random.Generator) -> np.ndarray:
    """Reference convention (audio_convert.py:46-53): truncated normal
    with scale 2**int(sample_bit*amplitude) counts, i.e. a float scale of
    2**int(16*amplitude)/32768 at 16-bit."""
    from scipy.stats import truncnorm

    scale = min(2.0 ** sample_bit, 2.0 ** int(sample_bit * amplitude))
    counts = truncnorm(-1, 1, scale=scale).rvs(n, random_state=rng)
    return (counts / float(2 ** (sample_bit - 1))).astype(np.float32)


def convert_one(src, args, rng):
    ext = os.path.splitext(src)[1].lower()
    if ext in (".pcm", ".raw"):
        if not (args.sample_rate and args.channel_num):
            raise SystemExit(
                f"raw PCM input {src} needs --sample_rate and --channel_num"
            )
        data = np.frombuffer(open(src, "rb").read(), dtype="<i2")
        audio = (data.astype(np.float32) / 32768.0).reshape(
            -1, args.channel_num
        )
        rate = args.sample_rate
    else:
        audio = load_wav(src, args.sample_rate, mono=False)
        rate = args.sample_rate or wave.open(src, "rb").getframerate()
    if audio.ndim == 1:
        audio = audio[:, None]

    if args.channel_num and audio.shape[1] != args.channel_num:
        if args.channel_num == 1:
            audio = audio.mean(axis=1, keepdims=True)
        elif audio.shape[1] == 1:
            audio = np.repeat(audio, args.channel_num, axis=1)
        else:
            raise SystemExit(
                f"cannot convert {audio.shape[1]} -> {args.channel_num} "
                f"channels: {src}"
            )

    if args.loudness is not None:
        rms = float(np.sqrt(np.mean(audio ** 2)))
        if rms > 0:
            cur_dbfs = 20.0 * np.log10(rms)
            audio = audio * (10.0 ** ((args.loudness - cur_dbfs) / 20.0))

    if args.clip_length:
        want = int(rate * args.clip_length / 1000.0)
        if want <= len(audio):
            audio = audio[-want:]  # clip from tail
        else:
            pad = np.zeros((want - len(audio), audio.shape[1]), np.float32)
            if args.fill_white_noise:
                pad = np.stack([
                    white_noise(len(pad), args.sample_bit or 16,
                                args.noise_amplitude, rng)
                    for _ in range(audio.shape[1])
                ], axis=1)
            audio = np.concatenate([pad, audio])  # pad at head

    dst = out_path(args.output_path, src, args.input_path
                   if os.path.isdir(args.input_path) else None)
    dst = os.path.splitext(dst)[0] + "." + args.target_format
    if args.target_format == "wav":
        _write_pcm(dst, audio, rate, args.sample_bit or 16)
    else:  # mp3 via ffmpeg (same gate as mp3_convert.sh)
        if shutil.which("ffmpeg") is None:
            raise SystemExit("--target_format mp3 needs ffmpeg on PATH")
        tmp = dst + ".tmp.wav"
        _write_pcm(tmp, audio, rate, 16)
        subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-i", tmp,
                        dst], check=True)
        os.remove(tmp)
    print(dst)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True,
                        help="audio file or directory (.wav/.pcm/.raw)")
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--channel_num", type=int, default=None,
                        help="target channels (None keeps)")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--sample_bit", type=int, default=None,
                        choices=[8, 16, 24, 32],
                        help="output PCM bit depth (None -> 16)")
    parser.add_argument("--loudness", type=float, default=None,
                        help="target loudness in dBFS (negative), "
                             "None keeps")
    parser.add_argument("--clip_length", type=int, default=None,
                        help="target length in ms: tail-clip or head-pad")
    parser.add_argument("--fill_white_noise", action="store_true",
                        help="pad with white noise instead of silence")
    parser.add_argument("--noise_amplitude", type=float, default=0.7,
                        help="white-noise amplitude (bit fraction, "
                             "reference convention). default=%(default)s")
    parser.add_argument("--target_format", default="wav",
                        choices=["wav", "mp3"])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    if os.path.isfile(args.input_path) and \
            os.path.splitext(args.input_path)[1].lower() in (".pcm", ".raw"):
        convert_one(args.input_path, args, rng)
    else:
        for wav_file in iter_wavs(args.input_path):
            convert_one(wav_file, args, rng)
        if os.path.isdir(args.input_path):
            # raw PCM inside a directory too (needs the decode params;
            # iter_wavs only globs *.wav)
            raw = sorted(
                p for ext in ("pcm", "raw")
                for p in glob(os.path.join(args.input_path, "**",
                                           f"*.{ext}"), recursive=True)
            )
            if raw and not (args.sample_rate and args.channel_num):
                raise SystemExit(
                    f"{len(raw)} .pcm/.raw files in {args.input_path} need "
                    "--sample_rate and --channel_num to decode"
                )
            for raw_file in raw:
                convert_one(raw_file, args, rng)


if __name__ == "__main__":
    main()
