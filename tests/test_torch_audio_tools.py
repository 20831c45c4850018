"""The port's audio tools (`tpu_speech_commands_torch/audio_process/`)
against the JAX package's scripts in `tools/audio_process/`, on the CPU.

The JAX scripts are loaded in this process by file path (their directory
on sys.path for `_common`), their `main()` run under a patched sys.argv;
the port's run through `main(argv)`.  On the same seeded wavs:

- every tool that writes files writes byte-equal files (the same relative
  paths), and prints the same lines with the output directory named the
  same; `add_noise`, `white_noise`, `audio_reverberation` and
  `audio_convert --fill_white_noise` get the same `--seed`;
- the report tools print equal reports;
- `vad_clip`, energy path: the same clip names and bytes; `--model_path`
  (`pretrained/direction_simple_gru.npz`, `--device cpu`) on noise, then
  `example/left_1.wav`'s last second, then noise: per-frame speech scores
  within atol 1e-5 of the JAX `model_scores` (the port's plain f32 chain
  against XLA), and the same clip files: exactly the word's second;
- the pyaudio tools print their `--help` and, where pyaudio is absent,
  stop with the JAX script's message.
"""
import contextlib
import importlib
import importlib.util
import io
import json
import os
import sys
import wave

import numpy as np
import pytest

from tpu_speech_commands_torch.params import pr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools", "audio_process")
GRU = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _jax_tool(name: str):
    """tools/audio_process/<name>.py as a module, loaded by file path."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(
        f"_jax_audio_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(name: str, argv: list) -> str:
    """The JAX script's main() on argv; returns what it printed."""
    module = _jax_tool(name)
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            module.main()
    finally:
        sys.argv = old
    return out.getvalue()


def run_port(name: str, argv: list) -> str:
    """The port's tool's main(argv); returns what it printed."""
    module = importlib.import_module(
        f"tpu_speech_commands_torch.audio_process.{name}")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        module.main(argv)
    return out.getvalue()


def tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _write_pcm(path, pcm: np.ndarray, rate=16000):
    """int16 (n,) or (n, channels) -> a wav."""
    pcm = pcm.reshape(len(pcm), -1)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(pcm.shape[1])
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(pcm.astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded wavs: two class directories with one same-named file each, a
    quiet file, a 22.05 kHz file, a stereo directory, a noise directory,
    a raw PCM directory, a wake word + command recording and a single
    long tone (for speech_command_split), and a JSONL annotation."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    sr = 16000
    t = np.arange(sr) / sr

    def pcm(x):
        return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)

    wavs = root / "wavs"
    for sub, freq in (("a", 300), ("b", 900)):
        (wavs / sub).mkdir(parents=True)
        x = 0.4 * np.sin(2 * np.pi * freq * t) + 0.01 * rng.standard_normal(sr)
        _write_pcm(wavs / sub / "tone.wav", pcm(x))
    # a short burst between silences (the VADs), and a quiet file
    burst = np.concatenate([0.001 * rng.standard_normal(8000),
                            0.5 * np.sin(2 * np.pi * 400 * t[:12000]),
                            0.001 * rng.standard_normal(9000)])
    _write_pcm(wavs / "burst.wav", pcm(burst))
    _write_pcm(wavs / "quiet.wav", np.zeros(sr, np.int16))
    _write_pcm(wavs / "rate22k.wav",
               pcm(0.3 * np.sin(2 * np.pi * 500 * np.arange(11025) / 22050)),
               rate=22050)
    stereo = root / "stereo"
    stereo.mkdir()
    _write_pcm(stereo / "st.wav", np.stack(
        [pcm(0.3 * np.sin(2 * np.pi * 200 * t)),
         pcm(0.2 * rng.standard_normal(sr))], axis=1))
    noise = root / "noise"
    noise.mkdir()
    for i in range(2):
        _write_pcm(noise / f"n{i}.wav", pcm(0.1 * rng.standard_normal(7000)))
    raw = root / "raw"
    raw.mkdir()
    (raw / "r.pcm").write_bytes(pcm(0.2 * rng.standard_normal(8000)).tobytes())

    def tone(seconds, freq):
        return 0.5 * np.sin(2 * np.pi * freq * np.arange(int(sr * seconds)) / sr)

    def silence(seconds):
        return 0.002 * rng.standard_normal(int(sr * seconds))

    split = root / "split_in"
    split.mkdir()
    _write_pcm(split / "good.wav", pcm(np.concatenate([
        silence(0.5), tone(0.6, 500), silence(0.9), tone(0.8, 700),
        silence(0.5)])))
    _write_pcm(split / "bad.wav", pcm(np.concatenate([
        silence(0.3), tone(2.0, 600), silence(0.3)])))
    ann = root / "ann.jsonl"
    ann.write_text("".join(json.dumps(r) + "\n" for r in (
        {"audio_filepath": "/old/a.wav", "text": "x"},
        {"audio_filepath": "/data/old/b.wav", "text": "y"},
        {"text": "no path"})) + "\n")
    return root


# (tool, flags); "{c}" is the corpus, "{out}" the output directory
WRITERS = {
    "add_noise": ("add_noise", ["--voice_path", "{c}/wavs", "--noise_path",
                                "{c}/noise", "--output_path", "{out}",
                                "--snr", "10", "--seed", "2"]),
    "white_noise": ("white_noise", ["--output_path", "{out}", "--count", "2",
                                    "--duration", "0.5", "--seed", "1"]),
    "audio_convert_8k_24bit": ("audio_convert", [
        "--input_path", "{c}/wavs", "--output_path", "{out}",
        "--sample_rate", "8000", "--sample_bit", "24"]),
    "audio_convert_stereo_to_mono_8bit": ("audio_convert", [
        "--input_path", "{c}/stereo", "--output_path", "{out}",
        "--channel_num", "1", "--sample_bit", "8", "--loudness", "-20"]),
    "audio_convert_pad_white_noise": ("audio_convert", [
        "--input_path", "{c}/wavs", "--output_path", "{out}",
        "--clip_length", "1500", "--fill_white_noise", "--seed", "3"]),
    "audio_convert_clip_32bit": ("audio_convert", [
        "--input_path", "{c}/wavs/a/tone.wav", "--output_path", "{out}",
        "--clip_length", "400", "--sample_bit", "32", "--channel_num", "2"]),
    "audio_convert_raw_pcm": ("audio_convert", [
        "--input_path", "{c}/raw", "--output_path", "{out}",
        "--channel_num", "1"]),
    "audio_reverberation": ("audio_reverberation", [
        "--input_path", "{c}/wavs", "--output_path", "{out}", "--seed", "1"]),
    "audio_split": ("audio_split", ["--input_path", "{c}/wavs",
                                    "--output_path", "{out}",
                                    "--chunk_time", "0.4", "--keep_last"]),
    "split_channel": ("split_channel", ["--input_path", "{c}/stereo",
                                        "--output_path", "{out}",
                                        "--channel", "1"]),
    "wav_filter_bandpass": ("wav_filter", [
        "--input_path", "{c}/wavs", "--output_path", "{out}",
        "--filter_type", "bandpass", "--cutoff", "250", "--cutoff_high",
        "1000", "--order", "4"]),
    "wav_filter_highpass": ("wav_filter", [
        "--input_path", "{c}/wavs/b", "--output_path", "{out}",
        "--filter_type", "highpass", "--cutoff", "500"]),
    "wav_merge": ("wav_merge", ["--voice_path", "{c}/wavs", "--noise_path",
                                "{c}/noise/n0.wav", "--output_path", "{out}",
                                "--volume_ratio", "0.5"]),
    "speech_command_split": ("speech_command_split", [
        "--wav_path", "{c}/split_in", "--split_output_path", "{out}/split",
        "--backup_path", "{out}/backup"]),
    "vad_clip_energy": ("vad_clip", ["--input_path", "{c}/wavs",
                                     "--output_path", "{out}",
                                     "--pad_t", "0.05"]),
    "annotation_update": ("annotation_update", [
        "--annotation_file", "{c}/ann.jsonl", "--output_file", "{out}/o.jsonl",
        "--old_prefix", "/old", "--new_prefix", "/new"]),
}


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_tool_writes_what_the_jax_tool_writes(case, corpus, tmp_path):
    """The same flags on the same corpus: byte-equal output files at the
    same relative paths, and the same printed lines."""
    tool, flags = WRITERS[case]
    outs = {}
    for who, run in (("jax", run_jax), ("port", run_port)):
        out = tmp_path / who
        if case == "annotation_update":
            out.mkdir()
        argv = [f.format(c=corpus, out=out) for f in flags]
        printed = run(tool, argv).replace(str(out), "<out>")
        outs[who] = (printed, tree(out))
    (jax_printed, jax_files), (printed, files) = outs["jax"], outs["port"]
    assert files, f"{case} wrote nothing"
    assert sorted(files) == sorted(jax_files)
    for rel, data in files.items():
        assert data == jax_files[rel], f"{case}: {rel} differs"
    assert printed == jax_printed


REPORTS = {
    "silent_check": ("silent_check", ["--input_path", "{c}/wavs"]),
    "wav_check": ("wav_check", ["--input_path", "{c}"]),
    "speech_duration_check": ("speech_duration_check",
                              ["--input_path", "{c}/wavs", "--ratio", "3"]),
    "speech_command_split_file": ("speech_command_split",
                                  ["--wav_path", "{c}/split_in/good.wav"]),
    "wav_play_info_only": ("wav_play", ["--wav_path", "{c}/wavs",
                                        "--info_only", "--chunk_size", "512"]),
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_report_equals_the_jax_tool(case, corpus):
    """A report tool prints what the JAX script prints."""
    tool, flags = REPORTS[case]
    argv = [f.format(c=corpus) for f in flags]
    want = run_jax(tool, argv)
    got = run_port(tool, argv)
    assert got == want
    assert got.strip()


def test_common_helpers_equal_jax(corpus, tmp_path):
    """iter_wavs and out_path (with its relative-subpath rule) as in the
    JAX `_common`."""
    from tpu_speech_commands_torch.audio_process import _common

    jax_common = _jax_tool("_common")
    root = str(corpus)
    assert list(_common.iter_wavs(root)) == list(jax_common.iter_wavs(root))
    single = os.path.join(root, "wavs", "quiet.wav")
    assert list(_common.iter_wavs(single)) == [single]
    for src in _common.iter_wavs(root):
        for base in (root, os.path.join(root, "stereo"), None):
            got = _common.out_path(str(tmp_path / "p"), src, base)
            want = jax_common.out_path(str(tmp_path / "p"), src, base)
            assert got == want
    assert _common.out_path(str(tmp_path), os.path.join(root, "wavs", "a",
                            "tone.wav"), root).endswith("wavs/a/tone.wav")


@pytest.fixture(scope="module")
def long_recording(tmp_path_factory):
    """2 s of noise, the last second of example/left_1.wav, 2 s of noise
    (`vad_clip.noise_word_noise`, which chip_smoke.py runs on the card)."""
    from tpu_speech_commands_torch.audio_process.vad_clip import \
        noise_word_noise

    src = tmp_path_factory.mktemp("vad") / "long.wav"
    noise_word_noise(str(src))
    return src


def test_vad_clip_model_path_matches_jax(long_recording, tmp_path):
    """--model_path with the simple_gru checkpoint on the CPU: the speech
    scores of the five frames within atol 1e-5 of the JAX `model_scores`,
    only the word's frame at or above the threshold, and the same clip
    files (one: the word's second, named after its end)."""
    from tpu_speech_commands.serving import make_batch_scorer as jax_scorer
    from tpu_speech_commands_torch.audio_process import vad_clip
    from tpu_speech_commands_torch.data.wav import load_wav
    from tpu_speech_commands_torch.serving import make_batch_scorer

    audio = load_wav(str(long_recording), 16000)
    jax_vad = _jax_tool("vad_clip")
    want = jax_vad.model_scores(audio, jax_scorer(GRU, use_pallas=False),
                                16000, 16000)
    scorer = make_batch_scorer(GRU, "cpu")
    got = vad_clip.model_scores(audio, scorer, scorer.params.max_samples,
                                16000)
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert [i for i, s in enumerate(got) if s >= 0.7] == [2]

    jax_out, out = tmp_path / "jax", tmp_path / "port"
    flags = ["--input_path", str(long_recording), "--model_path", GRU]
    run_jax("vad_clip", flags + ["--output_path", str(jax_out)])
    written = vad_clip.main(flags + ["--output_path", str(out),
                                     "--device", "cpu"])
    assert written == [str(out / "long_3.wav")]
    assert tree(out) == tree(jax_out)
    assert len(load_wav(written[0], 16000)) == 16000


def test_vad_clip_model_path_refuses_cuda_without_it(long_recording, tmp_path):
    """--device cuda (the default) where CUDA is absent raises; nothing
    falls back to the CPU."""
    import torch

    from tpu_speech_commands_torch.audio_process import vad_clip

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vad_clip.main(["--input_path", str(long_recording), "--output_path",
                       str(tmp_path), "--model_path", GRU])


@pytest.mark.parametrize("tool,flags", [
    ("audio_play", ["--input_path", "x.wav"]),
    ("audio_record", ["--output_file", "x.wav", "--duration", "0.1"]),
    ("wav_play", ["--wav_path", "{wav}"]),
])
def test_pyaudio_tools(tool, flags, corpus, capsys):
    """--help prints the JAX script's flags; without pyaudio, main stops
    with the JAX script's message."""
    module = importlib.import_module(
        f"tpu_speech_commands_torch.audio_process.{tool}")
    with pytest.raises(SystemExit) as e:
        module.main(["--help"])
    assert e.value.code == 0
    port_help = capsys.readouterr().out
    for flag in flags[::2]:
        assert flag in port_help
    try:
        import pyaudio  # noqa: F401
    except ImportError:
        argv = [f.format(wav=corpus / "wavs" / "quiet.wav") for f in flags]
        with pytest.raises(SystemExit) as got:
            with contextlib.redirect_stdout(io.StringIO()):
                module.main(argv)
        with pytest.raises(SystemExit) as want:
            run_jax(tool, argv)
        assert str(got.value) == str(want.value)
        assert "PyAudio is not installed" in str(got.value)
