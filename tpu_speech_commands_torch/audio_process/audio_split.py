"""Split wavs into fixed-length chunks
(reference: tools/audio_process/audio_split.py).

Counterpart of `tools/audio_process/audio_split.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.audio_split --help
"""
import argparse
import os

from ._common import iter_wavs, load_wav, save_audio


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--chunk_time", type=float, default=1.0, help="seconds")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--keep_last", action="store_true",
                        help="keep the final partial chunk")
    args = parser.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)
    chunk = int(args.chunk_time * args.sample_rate)
    for wav_file in iter_wavs(args.input_path):
        audio = load_wav(wav_file, args.sample_rate)
        stem = os.path.splitext(os.path.basename(wav_file))[0]
        n_full = len(audio) // chunk
        total = n_full + (1 if args.keep_last and len(audio) % chunk else 0)
        for i in range(total):
            seg = audio[i * chunk : (i + 1) * chunk]
            dst = os.path.join(args.output_path, f"{stem}_{i}.wav")
            save_audio(dst, seg, args.sample_rate)
            print(dst)


if __name__ == "__main__":
    main()
