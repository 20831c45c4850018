"""Extract one channel from multichannel wavs
(reference: tools/audio_process/split_channel.py).

Counterpart of `tools/audio_process/split_channel.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.split_channel --help
"""
import argparse
import wave

import numpy as np

from ._common import iter_wavs, out_path, save_audio


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--channel", type=int, default=0)
    args = parser.parse_args(argv)

    for wav_file in iter_wavs(args.input_path):
        with wave.open(wav_file, "rb") as wf:
            ch, width, rate = wf.getnchannels(), wf.getsampwidth(), wf.getframerate()
            assert width == 2, "only 16-bit wavs supported"
            data = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        assert args.channel < ch, f"{wav_file} has only {ch} channels"
        mono = data.reshape(-1, ch)[:, args.channel].astype(np.float32) / 32768.0
        dst = out_path(args.output_path, wav_file, args.input_path)
        save_audio(dst, mono, rate)
        print(dst)


if __name__ == "__main__":
    main()
