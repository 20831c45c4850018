"""Play wav files with a header-info dump (PyAudio-gated).

Counterpart of the reference's tools/audio_process/wav_play.py: prints the
wave header fields, preloads the file in chunks, then streams the chunks to
the default output device with a progress bar.  `--wav_path` accepts a
single file or a directory (every wav inside is played in turn).

Unlike audio_play.py (the minimal playback loop shared with the recorder),
this tool keeps the reference's flag surface and info output so scripts
written against the reference keep working.

Counterpart of `tools/audio_process/wav_play.py`, with its flags:

    python -m tpu_speech_commands_torch.audio_process.wav_play --help
"""
import argparse
import wave

from ._common import iter_wavs


def show_audio_info(wf: wave.Wave_read) -> None:
    print(f"channels: {wf.getnchannels()}")
    print(f"sample rate: {wf.getframerate()}")
    print(f"bits per sample: {wf.getsampwidth() * 8}")
    print(f"total frames: {wf.getnframes()}")
    print(f"duration seconds: {wf.getnframes() / wf.getframerate()} s")
    print(f"compress type: {wf.getcomptype()}")
    print(f"compress name: {wf.getcompname()}")


def load_chunks(wav_file: str, chunk_size: int):
    """Read the whole file as a list of frame chunks + its format tuple."""
    with wave.open(wav_file, "rb") as wf:
        print("\nAudio file info:")
        show_audio_info(wf)
        fmt = (wf.getsampwidth(), wf.getnchannels(), wf.getframerate())
        chunks = []
        data = wf.readframes(chunk_size)
        while data:
            chunks.append(data)
            data = wf.readframes(chunk_size)
    return chunks, fmt


def wav_play(wav_file: str, chunk_size: int) -> None:
    try:
        import pyaudio
    except ImportError:
        raise SystemExit("PyAudio is not installed — playback unavailable.")

    chunks, (width, channels, rate) = load_chunks(wav_file, chunk_size)
    p = pyaudio.PyAudio()
    stream = p.open(format=p.get_format_from_width(width),
                    channels=channels, rate=rate, output=True)
    print("\nStart playing")
    try:
        from tqdm import tqdm

        chunks = tqdm(chunks)
    except ImportError:
        pass
    for chunk in chunks:
        stream.write(chunk)
    stream.stop_stream()
    stream.close()
    p.terminate()
    print("Playing done.")


def main(argv=None):
    parser = argparse.ArgumentParser(description="play wav audio files")
    parser.add_argument("--wav_path", type=str, required=True,
                        help="wav file or directory to play")
    parser.add_argument("--chunk_size", type=int, default=1024,
                        help="audio frame chunk size. default=%(default)s")
    parser.add_argument("--info_only", action="store_true",
                        help="dump wav header info without playing "
                             "(works without PyAudio)")
    args = parser.parse_args(argv)

    wav_files = list(iter_wavs(args.wav_path))
    for i, wav_file in enumerate(wav_files):
        print(f"\nPlaying ({i + 1}/{len(wav_files)}): {wav_file}")
        if args.info_only:
            # header only — no need to read any frame data
            with wave.open(wav_file, "rb") as wf:
                print("\nAudio file info:")
                show_audio_info(wf)
        else:
            wav_play(wav_file, args.chunk_size)
    print("\nDone")


if __name__ == "__main__":
    main()
