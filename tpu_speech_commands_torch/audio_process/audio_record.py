"""Record audio from the microphone to a wav file (PyAudio-gated;
reference: tools/audio_process/audio_record.py).

Counterpart of `tools/audio_process/audio_record.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.audio_record --help
"""
import argparse

import numpy as np

from ._common import save_audio


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--duration", type=float, default=5.0)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--chunk_size", type=int, default=1024)
    args = parser.parse_args(argv)

    try:
        import pyaudio
    except ImportError:
        raise SystemExit("PyAudio is not installed — recording unavailable.")

    p = pyaudio.PyAudio()
    stream = p.open(format=pyaudio.paInt16, channels=1, rate=args.sample_rate,
                    input=True, frames_per_buffer=args.chunk_size)
    print(f"recording {args.duration}s ...")
    frames = []
    # ceil: flooring clips up to one chunk off the requested duration
    n_samples = int(args.sample_rate * args.duration)
    for _ in range(-(-n_samples // args.chunk_size)):
        frames.append(stream.read(args.chunk_size))
    stream.stop_stream()
    stream.close()
    p.terminate()
    audio = np.frombuffer(b"".join(frames), "<i2").astype(np.float32) / 32768.0
    save_audio(args.output_file, audio, args.sample_rate)
    print(f"saved {args.output_file}")


if __name__ == "__main__":
    main()
