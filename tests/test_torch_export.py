"""The port's export and model-format layer (`tpu_speech_commands_torch/
export/`, `native_binding.py`, `evaluation/statistics.py`, the external
paths of `eval`, `Listener` and `stream_server`) against the JAX package's,
on the CPU, with numpy only (no TensorFlow: test_torch_export_tf.py).

Tolerances:
- `.tscm` and `.onnx` files: byte for byte (the same writer);
- the port's `OnnxModel` against the JAX package's on the same file: 1e-6
  (the same numpy ops; a scratch run of both differed by 0);
- the port's `.tscm` through the port's own `libtsc.so` against the JAX
  package's `native_binding` on the same blob: 1e-6 (the same C++ sources,
  compiled apart);
- the `.onnx` loader's onnxruntime path against the numpy executor: 1e-6
  through a stand-in session on that executor (onnxruntime is not
  installed here), rtol 1e-4 / atol 1e-5 with the real one where it is;
- the port's NATIVE predict (the plain PyTorch model) against the ONNX
  scores: rtol 1e-4 / atol 1e-5, as tests/test_export.py holds the JAX
  forward to its ONNX export;
- `update_vectors` against the JAX Listener's: rtol 1e-4 / atol 1e-5, the
  bound of the frame features in tests/test_torch_streaming.py;
- external-format eval: accuracy and confusion equal to the JAX `eval`'s
  on its own features (argmaxes of scores 1e-6 apart);
- FLOPs: equal to 2 x the multiply-accumulates counted by hand below.
"""
import os
import shutil
import sys
import wave

import numpy as np
import pytest
import torch

import eval as jax_eval
from tpu_speech_commands.evaluation import get_model_statistics as jax_stats
from tpu_speech_commands.export import inference_loader as jax_loader
from tpu_speech_commands.export.native_format import \
    export_native as jax_export_native
from tpu_speech_commands.export.onnx_runtime_mini import OnnxModel as JaxOnnx
from tpu_speech_commands.export.onnx_writer import \
    export_onnx_model as jax_export_onnx
from tpu_speech_commands.streaming import Listener as JaxListener
from tpu_speech_commands_torch import eval as port_eval
from tpu_speech_commands_torch import export_model, model_statistics
from tpu_speech_commands_torch import stream_server
from tpu_speech_commands_torch.checkpoints import load_checkpoint
from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
from tpu_speech_commands_torch.evaluation import (clever_format, count_params,
                                                  get_model_statistics)
from tpu_speech_commands_torch.export import inference_loader as port_loader
from tpu_speech_commands_torch.export.inference_loader import (
    load_inference_model, resolve_checkpoint_contract)
from tpu_speech_commands_torch.export.native_format import (export_native,
                                                            read_native_model)
from tpu_speech_commands_torch.export.onnx_runtime_mini import OnnxModel
from tpu_speech_commands_torch.export.onnx_writer import export_onnx_model
from tpu_speech_commands_torch.models import init_model
from tpu_speech_commands_torch.native_binding import NativeModel
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.streaming import Listener
from tpu_speech_commands_torch.training.checkpoints import (flatten_variables,
                                                            save_checkpoint)
from tpu_speech_commands_torch.utils import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES_PATH = os.path.join(REPO, "configs", "direction_classes.txt")
CLASSES = ["background", "left", "right", "up", "down"]
MODEL_TYPES = ("simple_gru", "simple_lstm", "simple_cnn", "simple_cnn_lite")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """Checkpoint loads write the port's own `pr`, which tests/conftest.py
    does not restore: snapshot and restore it here."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _fresh(tmp_path, model_type: str) -> str:
    """A fresh `init_model` checkpoint at 3 classes, written by the port."""
    _, variables = init_model(model_type, 3, seed=7)
    path = str(tmp_path / f"{model_type}.npz")
    save_checkpoint(path, variables, {"model_type": model_type,
                                      "num_classes": 3,
                                      "classes": CLASSES[:3]})
    return path


def _checkpoint(tmp_path, source: str, model_type: str) -> str:
    if source == "fresh":
        return _fresh(tmp_path, model_type)
    return os.path.join(REPO, "pretrained", f"direction_{model_type}.npz")


def _features(n: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, 30, 20))
    return x.astype(np.float32)


def _pcm(name: str) -> np.ndarray:
    with wave.open(os.path.join(REPO, "example", name), "rb") as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), "<i2")


# -- the writers, byte for byte ----------------------------------------------

@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("source", ["fresh", "pretrained"])
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_export_native_bytes_equal_jax(model_type, source, quantize, tmp_path):
    ckpt = _checkpoint(tmp_path, source, model_type)
    ours = export_native(ckpt, str(tmp_path / "port.tscm"), quantize=quantize)
    theirs = jax_export_native(ckpt, str(tmp_path / "jax.tscm"),
                               quantize=quantize)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    if source == "pretrained" and not quantize:
        shipped = ckpt[:-len(".npz")] + ".tscm"
        with open(ours, "rb") as a, open(shipped, "rb") as b:
            assert a.read() == b.read()
    # the reader: f32 tensors back exactly, q8 within half a scale step
    tensors, meta = read_native_model(ours)
    flat = flatten_variables(load_checkpoint(ckpt)[0])
    assert sorted(tensors) == sorted(flat)
    assert meta["model_type"] == model_type
    for name, want in flat.items():
        step = (np.abs(want.reshape(-1, want.shape[-1])).max(0) / 127.0
                if quantize and want.ndim >= 2 and name.endswith("kernel")
                else 0.0)
        assert np.all(np.abs(tensors[name] - want)
                      <= step / 2 * (1 + 1e-6) + 1e-7), name


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_onnx_bytes_and_scores_equal_jax(model_type, tmp_path):
    """write_onnx_model's bytes, the two OnnxModels' scores (1e-6), and
    the port's NATIVE predict on the CPU (rtol 1e-4 / atol 1e-5)."""
    ckpt = _fresh(tmp_path, model_type)
    ours = export_onnx_model(ckpt, str(tmp_path / "port.onnx"))
    theirs = jax_export_onnx(ckpt, str(tmp_path / "jax.onnx"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    x = _features(4, seed=1)
    feed = x[..., None] if "cnn" in model_type else x
    got = OnnxModel(ours).run({"feature_input": feed})["score_predict"]
    want = JaxOnnx(ours).run({"feature_input": feed})["score_predict"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    predict, fmt = load_inference_model(ours)
    assert fmt == "ONNX"
    np.testing.assert_allclose(predict(x), want, rtol=0, atol=1e-6)
    native, fmt = load_inference_model(ckpt, "cpu")
    assert fmt == "NATIVE"
    np.testing.assert_allclose(native(x).numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_tscm_runtime_equals_jax_binding(model_type, tmp_path, native_lib):
    """The port's g++ build of native/ against the JAX package's cmake
    build, on the same blob, f32 and q8."""
    from tpu_speech_commands.native_binding import NativeModel as JaxNative

    x = _features(3, seed=2)
    for quantize in (False, True):
        blob = export_native(_fresh(tmp_path, model_type),
                             str(tmp_path / f"m{int(quantize)}.tscm"),
                             quantize=quantize)
        ours, theirs = NativeModel(blob), JaxNative(blob)
        assert (ours.num_classes, ours.n_features, ours.feature_width) == \
            (3, 30, 20)
        for row in x:
            np.testing.assert_allclose(ours.predict(row), theirs.predict(row),
                                       rtol=0, atol=1e-6)
        predict, fmt = load_inference_model(blob)
        assert fmt == "TSCM"
        np.testing.assert_allclose(
            predict(x), np.stack([theirs.predict(r) for r in x]),
            rtol=0, atol=1e-6)
    lib = native_build.ensure_native_library()
    assert lib.parent == native_build.BUILD_DIR and lib.exists()


def test_native_frontend_and_streamer_equal_jax(native_lib):
    """NativeFrontend and NativeStreamer over the port's build against the
    JAX package's binding: the same features (1e-6) and step results."""
    from tpu_speech_commands.native_binding import NativeFrontend as JaxFe
    from tpu_speech_commands.native_binding import NativeModel as JaxNative
    from tpu_speech_commands.native_binding import NativeStreamer as JaxStream
    from tpu_speech_commands_torch.native_binding import (NativeFrontend,
                                                          NativeStreamer)

    audio = _pcm("up_1.wav").astype(np.float32) / 32768.0
    got, want = NativeFrontend()(audio), JaxFe()(audio)
    assert got.shape == want.shape == (30, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    blob = os.path.join(REPO, "pretrained", "direction_simple_gru.tscm")
    ours = NativeStreamer(NativeModel(blob))
    theirs = JaxStream(JaxNative(blob))
    steps = [(ours.step(c), theirs.step(c))
             for c in audio[:len(audio) // 1024 * 1024].reshape(-1, 1024)]
    for got, want in steps:
        assert got.keys() == want.keys()
        assert (got["index"], got["background"], got["triggered"]) == \
            (want["index"], want["background"], want["triggered"])
        assert abs(got["score"] - want["score"]) <= 1e-6
    with pytest.raises(ValueError, match="1024"):
        ours.step(np.zeros(10, np.float32))


def test_native_build_fails_loudly(tmp_path, monkeypatch):
    """A compiler that fails raises with its command; nothing falls back."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CXX", "false")
    native_build.ensure_native_library.cache_clear()
    try:
        with pytest.raises(native_build.NativeBuildError, match="false"):
            native_build.ensure_native_library()
        assert not list((tmp_path / "b").glob("*.so"))
    finally:
        native_build.ensure_native_library.cache_clear()


# -- the loader --------------------------------------------------------------

SUFFIXES = {"m.npz": "NATIVE", "m.pb": "PB", "m.tflite": "TFLITE",
            "m.h5": "H5", "m.keras": "H5", "saved_model_dir": "SAVED_MODEL",
            "m.tscm": "TSCM", "m.onnx": "ONNX"}


@pytest.mark.parametrize("name", sorted(SUFFIXES))
def test_loader_names_formats_as_jax(name, tmp_path, monkeypatch):
    """Dispatch only: each backend replaced by a stub in both packages."""
    path = str(tmp_path / name)
    if name == "saved_model_dir":
        os.makedirs(path)
    for module in (jax_loader, port_loader):
        for fn in ("load_native", "load_frozen_pb", "load_tflite",
                   "load_keras", "load_saved_model", "_load_tscm",
                   "_load_onnx_mini", "_load_onnx"):
            monkeypatch.setattr(module, fn, lambda *a, **k: "stub")
    want = jax_loader.load_inference_model(path)
    got = port_loader.load_inference_model(path, "cpu")
    assert got == want == ("stub", SUFFIXES[name])


class _FakeSession:
    """onnxruntime's `InferenceSession` as `_load_onnx` uses it, run by the
    port's numpy executor; the input's shape as the writer declares it."""

    def __init__(self, path, providers):
        assert providers == ["CPUExecutionProvider"]
        self.model = OnnxModel(path)
        rank = 4 if self.model.nodes[0][0] == "Transpose" else 3
        self.input = type("Input", (), {"name": self.model.inputs[0],
                                        "shape": ["N", 30, 20, 1][:rank]})

    def get_inputs(self):
        return [self.input]

    def run(self, names, feeds):
        assert names is None
        return [self.model.run(feeds)["score_predict"]]


@pytest.mark.parametrize("model_type", ["simple_gru", "simple_cnn"])
def test_onnx_loader_prefers_onnxruntime(model_type, tmp_path, monkeypatch):
    """With onnxruntime importable, `.onnx` goes through `_load_onnx` (here
    a stand-in session on the numpy executor), rank adapted either way:
    the scores equal the numpy executor's within 1e-6."""
    onnx = export_onnx_model(
        os.path.join(REPO, "pretrained", f"direction_{model_type}.npz"),
        str(tmp_path / "m.onnx"))
    want = port_loader._load_onnx_mini(onnx)(_features(3, 5))
    fake = type(os)("onnxruntime")
    fake.InferenceSession = _FakeSession
    monkeypatch.setitem(sys.modules, "onnxruntime", fake)
    predict, fmt = load_inference_model(onnx, "cpu")
    assert fmt == "ONNX" and predict.__qualname__.startswith("_load_onnx.")
    for feats in (_features(3, 5), _features(3, 5)[..., None]):
        np.testing.assert_allclose(predict(feats), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model_type", ["simple_gru", "simple_cnn"])
def test_onnxruntime_scores_equal_mini(model_type, tmp_path):
    """The real onnxruntime, where installed, against the numpy executor on
    the same export: rtol 1e-4 / atol 1e-5."""
    pytest.importorskip("onnxruntime")
    onnx = export_onnx_model(
        os.path.join(REPO, "pretrained", f"direction_{model_type}.npz"),
        str(tmp_path / "m.onnx"))
    feats = _features(3, 5)
    np.testing.assert_allclose(port_loader._load_onnx(onnx)(feats),
                               port_loader._load_onnx_mini(onnx)(feats),
                               rtol=RTOL, atol=ATOL)


def test_loader_refusals_match_jax(tmp_path):
    for module in (jax_loader, port_loader):
        with pytest.raises(ImportError, match="MNN"):
            module.load_inference_model(str(tmp_path / "m.mnn"))
        with pytest.raises(ValueError, match="invalid model file"):
            module.load_inference_model(str(tmp_path / "m.bin"))


def test_checkpoint_contract(tmp_path):
    """External formats take the flag (mfcc by default); a native
    checkpoint its stored feature type and its class count."""
    predict, fmt = load_inference_model(
        os.path.join(REPO, "pretrained", "direction_simple_gru.npz"), "cpu")
    assert resolve_checkpoint_contract(predict, fmt, CLASSES) == "mfcc"
    with pytest.raises(ValueError, match="4 entries"):
        resolve_checkpoint_contract(predict, fmt, CLASSES[:4])
    warned = []
    assert resolve_checkpoint_contract(predict, fmt, CLASSES, "bark",
                                       warn=warned.append) == "bark"
    assert len(warned) == 1 and "stored feature_type=mfcc" in warned[0]
    assert resolve_checkpoint_contract(None, "ONNX", CLASSES[:2]) == "mfcc"
    assert resolve_checkpoint_contract(None, "TSCM", None, "bark") == "bark"


# -- the external paths of listen, the server and eval -----------------------

@pytest.mark.parametrize("chunk_size", [1024, 800])
def test_update_vectors_equals_jax(chunk_size, tmp_path):
    onnx = export_onnx_model(
        os.path.join(REPO, "pretrained", "direction_simple_gru.npz"),
        str(tmp_path / "gru.onnx"))
    kw = dict(model_path=onnx, classes_path=CLASSES_PATH,
              chunk_size=chunk_size)
    ours, theirs = Listener(device="cpu", **kw), JaxListener(**kw)
    assert ours.model_format == theirs.model_format == "ONNX"
    pcm = _pcm("left_1.wav")
    scorer = Listener(device="cpu", **kw)
    for lo in range(0, len(pcm) - chunk_size + 1, chunk_size):
        chunk = pcm[lo:lo + chunk_size].tobytes()
        got, want = ours.update_vectors(chunk), theirs.update_vectors(chunk)
        assert got.shape == want.shape == (30, 20, 1)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(scorer.process_chunk(chunk),
                                   theirs.predict_fn(want[None])[0],
                                   rtol=RTOL, atol=ATOL)
    native = Listener(model_path=os.path.join(
        REPO, "pretrained", "direction_simple_gru.npz"),
        classes_path=CLASSES_PATH, device="cpu")
    with pytest.raises(AssertionError, match="external-format"):
        native.update_vectors(pcm[:1024].tobytes())


def test_stream_server_on_onnx_equals_native(tmp_path, capsys):
    ckpt = os.path.join(REPO, "pretrained", "direction_simple_cnn_lite.npz")
    onnx = export_onnx_model(ckpt, str(tmp_path / "lite.onnx"))
    wavs = [os.path.join(REPO, "example", n)
            for n in ("left_1.wav", "up_2.wav", "down_1.wav")]
    events = {}
    for path in (ckpt, onnx):
        events[path] = stream_server.main([
            "--model_path", path, "--classes_path", CLASSES_PATH,
            "--wavs", *wavs, "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ONNX model" in out and "NATIVE model" in out
    assert events[onnx] == events[ckpt]
    assert [e["command"] for e in events[onnx]] == ["left", "up", "down"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("export_corpus"))
    make_synthetic_dataset(root, CLASSES, samples_per_class=4, seed=3)
    return root


@pytest.mark.parametrize("fmt", ["onnx", "tscm"])
def test_external_eval_equals_jax(fmt, corpus, tmp_path, monkeypatch):
    """eval.main on an exported simple_gru: the port's features (its
    frontend on the CPU) into the host runtime, against the JAX eval.main
    on the same file (its own features)."""
    monkeypatch.setenv("TSC_COMPILATION_CACHE", "off")
    ckpt = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")
    model = str(tmp_path / f"gru.{fmt}")
    (export_onnx_model if fmt == "onnx" else export_native)(ckpt, model)
    confusions = []
    monkeypatch.setattr(jax_eval, "plot_confusion_matrix",
                        lambda conf, *a: confusions.append(conf))
    results = []
    for i, run in enumerate((jax_eval.main, port_eval.main)):
        data = str(tmp_path / f"ds{i}")
        shutil.copytree(os.path.join(corpus, "sounds"),
                        os.path.join(data, "sounds"))
        argv = ["--model_path", model, "--dataset_path", data,
                "--classes_path", CLASSES_PATH, "--batch_size", "8",
                "--output_path", str(tmp_path / "result")]
        parser = (jax_eval if i == 0 else port_eval).build_parser()
        results.append(run(parser.parse_args(
            argv + ([] if i == 0 else ["--device", "cpu"]))))
    want_acc, (got_acc, got_conf) = results
    assert got_acc == want_acc
    np.testing.assert_array_equal(got_conf, confusions[0])
    assert got_conf.sum() == 20


# -- statistics --------------------------------------------------------------

def _analytic_flops(model_type: str) -> int:
    """2 x the multiply-accumulates of one window, at 30 x 20 features and
    5 classes."""
    if model_type == "simple_gru":
        steps, d, u = 30, 20, 48
        return 2 * (steps * (d * 3 * u + u * 3 * u) + u * 5)
    # simple_cnn: (out positions, cin, cout) of each 3x3 conv, SAME pads,
    # pools after blocks 1, 2 and 4, block 3 at stride 2
    convs = [(30 * 20, 1, 16), (15 * 10, 16, 32), (4 * 3, 32, 64),
             (4 * 3, 64, 128)]
    macs = sum(pos * cin * cout * 9 for pos, cin, cout in convs)
    macs += (2 * 1 * 128) * 128 + 128 * 5  # feature_dense, score_predict
    return 2 * macs


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_statistics(model_type, capsys):
    stats = get_model_statistics(model_type, 5, batch_size=2)
    want = jax_stats(model_type, 5, batch_size=2)
    assert stats["params"] == want["params"]
    assert count_params(init_model(model_type, 5)[0]) == want["params"]
    assert set(stats) == set(want)
    print(f"{model_type}: FLOPs port {stats['flops']:.0f}, JAX XLA "
          f"{want['flops']:.0f}, ratio {stats['flops'] / want['flops']:.4f}")
    if model_type in ("simple_gru", "simple_cnn"):
        assert stats["flops"] == 2 * _analytic_flops(model_type)
    assert stats["flops_str"] == clever_format(stats["flops"])
    assert clever_format(1234.0) == "1.234K" and clever_format(5) == "5.000B"


def test_model_statistics_and_export_entry_points(tmp_path, capsys):
    stats = model_statistics.main(["--model_type", "simple_gru"])
    assert stats["flops"] == _analytic_flops("simple_gru")
    out = capsys.readouterr().out
    assert "Total params: 10325" in out
    ckpt = os.path.join(REPO, "pretrained", "direction_simple_lstm.npz")
    for fmt, suffix, writer in (("native", "tscm", export_native),
                                ("onnx", "onnx", export_onnx_model)):
        path = export_model.main(["--checkpoint", ckpt, "--format", fmt,
                                  "--output_path", str(tmp_path / f"m.{suffix}")])
        want = writer(ckpt, str(tmp_path / f"w.{suffix}"))
        with open(path, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
    q8 = export_model.main(["--checkpoint", ckpt, "--format", "native",
                            "--quantize", "--output_path",
                            str(tmp_path / "q.tscm")])
    assert os.path.getsize(q8) < os.path.getsize(path) / 2
    np.save(tmp_path / "feats.npy", np.zeros((2, 30, 20), np.float32))
    assert export_model.load_calibration(str(tmp_path / "feats.npy")).shape \
        == (2, 30, 20)
    np.savez(tmp_path / "two.npz", a=np.zeros(1), b=np.zeros(1))
    with pytest.raises(ValueError, match="features"):
        export_model.load_calibration(str(tmp_path / "two.npz"))
    assert torch.is_tensor(load_inference_model(ckpt, "cpu")[0](
        np.zeros((1, 30, 20), np.float32)))
