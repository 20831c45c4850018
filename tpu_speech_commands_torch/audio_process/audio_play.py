"""Play wav files through the default output device (PyAudio-gated;
reference: tools/audio_process/{audio_play,wav_play}.py).

Counterpart of `tools/audio_process/audio_play.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.audio_play --help
"""
import argparse
import wave

from ._common import iter_wavs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--chunk_size", type=int, default=1024)
    args = parser.parse_args(argv)

    try:
        import pyaudio
    except ImportError:
        raise SystemExit("PyAudio is not installed — playback unavailable.")

    p = pyaudio.PyAudio()
    for wav_file in iter_wavs(args.input_path):
        print(f"playing {wav_file}")
        with wave.open(wav_file, "rb") as wf:
            stream = p.open(
                format=p.get_format_from_width(wf.getsampwidth()),
                channels=wf.getnchannels(), rate=wf.getframerate(), output=True,
            )
            data = wf.readframes(args.chunk_size)
            while data:
                stream.write(data)
                data = wf.readframes(args.chunk_size)
            stream.stop_stream()
            stream.close()
    p.terminate()


if __name__ == "__main__":
    main()
