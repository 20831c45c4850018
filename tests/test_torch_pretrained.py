"""The port's `dev/make_pretrained.py`, `dev/bench_native.py`,
`dev/make_chimes.py` and `plot_audio.py` against the JAX package's
scripts, on the CPU.

- `make_pretrained`, a tiny run (simple_gru, 5 classes x 8 clips, 2
  epochs): the `.npz` loads through the JAX `load_inference_model`, and
  the JAX package scores the example clips with it within atol 1e-5 of the
  port; the port's `.tscm` is byte-equal to the JAX `export_native` of the
  same `.npz`; the gate refuses a result below 8/8;
- `make_pretrained`'s verification on the shipped checkpoints: the JAX
  script's printed predictions, line for line;
- `bench_native`: the app build leaves both binaries, and a short run
  prints one JSON line with the JAX script's keys;
- `make_chimes`: the wavs byte-equal to the JAX script's;
- `plot_audio`: a PNG.
"""
import concurrent.futures
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_speech_commands_torch.params import pr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["simple_cnn", "simple_cnn_lite", "simple_gru", "simple_lstm"]


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


@pytest.fixture(scope="module", autouse=True)
def apps_build():
    """The native apps' g++ build (`ensure_native_apps`, once a process),
    started when the module starts so that it runs beside the module's
    other tests; the tests of the apps wait for it."""
    from tpu_speech_commands_torch.utils.native_build import \
        ensure_native_apps

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(ensure_native_apps)


def _jax_script(rel_path: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel_path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_scores(npz: str) -> np.ndarray:
    """The JAX make_pretrained verification's scores of example/*.wav: the
    JAX loader's predict_fn on the JAX Frontend's features."""
    from tpu_speech_commands.data.wav import load_wav
    from tpu_speech_commands.export.inference_loader import \
        load_inference_model
    from tpu_speech_commands.frontend import Frontend
    from tpu_speech_commands.params import pr as jax_pr
    from tpu_speech_commands_torch.dev.make_pretrained import example_wavs

    predict_fn, fmt = load_inference_model(npz)
    assert fmt == "NATIVE"
    frontend = Frontend(jax_pr)
    feats = [np.asarray(frontend(np.asarray(frontend.pad_audio(load_wav(w)))))
             for w in example_wavs()]
    return np.asarray(predict_fn(np.stack(feats)))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """make_pretrained.main on the CPU: simple_gru, 8 clips a class, 2
    epochs (the recipe's `EPOCHS` patched; TensorBoard off: this process
    needs no TensorFlow).  Returns
    (out dir, printed text, the SystemExit or None)."""
    from tpu_speech_commands_torch.dev import make_pretrained
    from tpu_speech_commands_torch.training import trainer

    out = tmp_path_factory.mktemp("pretrained")
    mp = pytest.MonkeyPatch()
    logger = trainer.MetricsLogger
    mp.setattr(make_pretrained, "EPOCHS", 2)
    mp.setattr(trainer, "MetricsLogger",
               lambda log_dir, tensorboard=True: logger(log_dir, False))
    snap = pr.to_dict()
    refused = None
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            try:
                make_pretrained.main(["--out", str(out), "--models",
                                      "simple_gru", "--samples_per_class",
                                      "8", "--device", "cpu"])
            except SystemExit as e:
                refused = e
    finally:
        mp.undo()
        pr.override(snap)
    return out, printed.getvalue(), refused


def test_tiny_run_scores_the_same_in_jax(tiny_run):
    """The port-trained .npz loads in the JAX package and scores the
    example clips within atol 1e-5 of the port's plain chain."""
    from tpu_speech_commands_torch.dev.make_pretrained import score_examples

    out, _, _ = tiny_run
    npz = str(out / "direction_simple_gru.npz")
    got, fmt = score_examples(npz, "cpu")
    assert fmt == "NATIVE" and got.shape == (8, 5)
    np.testing.assert_allclose(got, _jax_scores(npz), atol=1e-5, rtol=0)


def test_tiny_run_tscm_equals_jax_export(tiny_run, tmp_path):
    """The port's .tscm of the tiny run is the JAX writer's, byte for
    byte, and scores as the .npz does within the C++ runtime's 1e-4."""
    from tpu_speech_commands.export.native_format import export_native
    from tpu_speech_commands_torch.dev.make_pretrained import score_examples

    out, _, _ = tiny_run
    want = tmp_path / "jax.tscm"
    export_native(str(out / "direction_simple_gru.npz"), str(want))
    assert (out / "direction_simple_gru.tscm").read_bytes() == \
        want.read_bytes()
    native, fmt = score_examples(str(out / "direction_simple_gru.tscm"), "cpu")
    assert fmt == "TSCM"
    npz, _ = score_examples(str(out / "direction_simple_gru.npz"), "cpu")
    np.testing.assert_allclose(native, npz, atol=1e-4, rtol=0)


def test_tiny_run_gate_and_report(tiny_run):
    """The run prints its JSON line of accuracies; it exits through the
    gate exactly when an artifact is below 8/8 (2 epochs on 40 clips
    are)."""
    _, printed, refused = tiny_run
    line = [ln for ln in printed.splitlines() if ln.startswith("{")][-1]
    results = json.loads(line)
    assert list(results) == ["simple_gru"]
    r = results["simple_gru"]
    assert set(r) == {"npz", "tscm", "train_seconds"}
    below = r["npz"] < 1.0 or r["tscm"] < 1.0
    assert below == (refused is not None)
    if refused is not None:
        assert "simple_gru" in str(refused.code)
    assert "direction_simple_gru.npz (NATIVE): example accuracy" in printed
    assert "direction_simple_gru.tscm (TSCM): example accuracy" in printed


@pytest.mark.parametrize("results,bad", [
    ({"a": {"npz": 1.0, "tscm": 1.0}, "b": {"npz": 1.0, "tscm": 1.0}}, None),
    ({"a": {"npz": 1.0, "tscm": 1.0}, "b": {"npz": 0.875, "tscm": 1.0}},
     "['b']"),
    ({"a": {"npz": 1.0, "tscm": 0.875}}, "['a']"),
])
def test_gate_refuses_below_8_of_8(results, bad):
    from tpu_speech_commands_torch.dev.make_pretrained import check_gate

    if bad is None:
        check_gate(results)
        return
    with pytest.raises(SystemExit) as e:
        check_gate(results)
    assert str(e.value) == f"models below 100% on example wavs: {bad}"


def test_make_pretrained_refuses_cuda_without_it(tmp_path):
    """The default device is the card: without CUDA it raises before any
    work; nothing falls back to the CPU."""
    from tpu_speech_commands_torch.dev import make_pretrained

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_pretrained.main(["--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("family", FAMILIES)
def test_verify_matches_jax_script(family):
    """The shipped .npz through both scripts' verify_on_examples: the same
    printed predictions and accuracy line (8/8)."""
    from tpu_speech_commands_torch.dev import make_pretrained

    jax_script = _jax_script("tools/dev/make_pretrained.py",
                             "_jax_make_pretrained")
    npz = os.path.join(REPO, "pretrained", f"direction_{family}.npz")
    with contextlib.redirect_stdout(io.StringIO()) as want:
        jax_acc = jax_script.verify_on_examples(npz)
    with contextlib.redirect_stdout(io.StringIO()) as got:
        acc = make_pretrained.verify_on_examples(npz, "cpu")
    assert acc == jax_acc == 1.0
    assert got.getvalue() == want.getvalue()


def test_verify_tscm_matches_jax_script(native_lib):
    """The shipped simple_gru .tscm: the JAX script's printed predictions
    (its C++ runtime on XLA features; the port's on the plain chain's)."""
    from tpu_speech_commands_torch.dev import make_pretrained

    jax_script = _jax_script("tools/dev/make_pretrained.py",
                             "_jax_make_pretrained")
    tscm = os.path.join(REPO, "pretrained", "direction_simple_gru.tscm")
    with contextlib.redirect_stdout(io.StringIO()) as want:
        jax_script.verify_on_examples(tscm)
    with contextlib.redirect_stdout(io.StringIO()) as got:
        acc = make_pretrained.verify_on_examples(tscm, "cpu")
    assert acc == 1.0
    assert got.getvalue() == want.getvalue()


JSON_KEYS = {"metric", "value", "unit", "vs_baseline", "rows"}
ROW_KEYS = {"family", "invoke_f32_ms", "invoke_int8_ms", "stream_step_us"}


def test_bench_native_builds_apps_and_prints_json(apps_build, capsys):
    """ensure_native_apps leaves both binaries (g++, one call each); a
    short bench run prints the host CPU and one JSON line with the JAX
    script's keys, a row a family."""
    from tpu_speech_commands_torch.dev import bench_native
    from tpu_speech_commands_torch.utils.native_build import (
        APPS, ensure_native_apps)

    apps = apps_build.result()
    assert ensure_native_apps() == apps
    assert sorted(apps) == sorted(APPS)
    for path in apps.values():
        assert path.exists() and os.access(path, os.X_OK)
    result = bench_native.main(["--loop_count", "5", "--runs", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("host CPU: ")
    printed = json.loads(lines[-1])
    assert printed == result
    assert set(printed) == JSON_KEYS
    assert printed["metric"] == "native_invoke_ms_simple_gru"
    assert [r["family"] for r in printed["rows"]] == FAMILIES
    for row in printed["rows"]:
        assert set(row) == ROW_KEYS
        assert all(row[k] > 0 for k in ROW_KEYS - {"family"})
    # the keys of the JAX script's line, read from its source
    with open(os.path.join(REPO, "tools", "evaluation",
                           "bench_native.py")) as f:
        source = f.read()
    for key in JSON_KEYS | ROW_KEYS:
        assert f'"{key}"' in source


@pytest.mark.parametrize("name,want", [
    ("Intel(R) Xeon(R) Processor", "Intel(R) Xeon(R) Processor, 2 CPUs at 2600 MHz"),
    ("unknown", "GenuineIntel family 6 model 143 (model name unknown), 2 CPUs "
                "at 2600 MHz"),
])
def test_bench_native_names_the_host_cpu(name, want, tmp_path):
    """The CPU line from /proc/cpuinfo's fields, also where a virtualised
    kernel reports the model name as unknown."""
    from tpu_speech_commands_torch.dev.bench_native import host_cpu

    cpuinfo = tmp_path / "cpuinfo"
    cpuinfo.write_text("".join(
        f"processor\t: {i}\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
        f"model\t\t: 143\nmodel name\t: {name}\ncpu MHz\t\t: 2600.002\n\n"
        for i in range(2)))
    assert host_cpu(str(cpuinfo)) == want


def test_native_apps_build_fails_loudly(apps_build, tmp_path, monkeypatch):
    """A compiler that fails raises with its command and leaves no app."""
    from tpu_speech_commands_torch.utils import native_build

    apps_build.result()  # the module's own build is done before CXX changes
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CXX", "false")
    native_build.ensure_native_apps.cache_clear()
    try:
        with pytest.raises(native_build.NativeBuildError,
                           match="speech_commands_stream"):
            native_build.ensure_native_apps()
        assert not [p for p in (tmp_path / "b").iterdir() if p.is_file()]
    finally:
        native_build.ensure_native_apps.cache_clear()


def test_make_chimes_equals_jax_script(tmp_path):
    """--all: activate.wav and wozai.wav byte-equal to the JAX script's."""
    from tpu_speech_commands_torch.dev import make_chimes

    jax_script = _jax_script("tools/dev/make_chimes.py", "_jax_make_chimes")
    old = sys.argv
    sys.argv = ["make_chimes", "--all", "--output_dir", str(tmp_path / "jax")]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jax_script.main()
    finally:
        sys.argv = old
    with contextlib.redirect_stdout(io.StringIO()):
        written = make_chimes.main(["--all", "--output_dir",
                                    str(tmp_path / "port")])
    assert [os.path.basename(w) for w in written] == ["wozai.wav",
                                                      "activate.wav"]
    for w in written:
        with open(w, "rb") as got, \
                open(tmp_path / "jax" / os.path.basename(w), "rb") as want:
            assert got.read() == want.read()


def test_plot_audio_writes_png(tmp_path):
    """plot_audio on a clip: a PNG, and the STFT it plots."""
    from tpu_speech_commands_torch import plot_audio

    out = tmp_path / "plot.png"
    with contextlib.redirect_stdout(io.StringIO()):
        audio, f, t, z = plot_audio.main([
            "--audio_file", os.path.join(REPO, "example", "left_1.wav"),
            "--output_file", str(out), "--n_fft", "512"])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert z.shape == (len(f), len(t)) and len(f) == 257
    assert np.isfinite(audio).all()
