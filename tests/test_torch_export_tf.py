"""The port's TensorFlow-backed formats (Keras h5, SavedModel, TFLite,
frozen pb) against the JAX package's exports of the same checkpoint, on the
CPU.  Skipped where TensorFlow is not installed.

Tolerances, those of tests/test_keras_interop.py and tests/test_export.py:
- the h5 import and export round trips, scores of the port's model against
  tf.keras: rtol 1e-4 / atol 1e-5;
- SavedModel and pb, the port's export against the JAX package's: rtol
  1e-4 / atol 1e-5 (two f32 graphs of one function);
- TFLite, the port's against the JAX package's: rtol 1e-3 / atol 1e-4
  (TFLite's own kernels);
- a Listener on the port's .tflite against the native Listener: the TFLite
  bound, and equal trigger events;
- the int8 TFLite (`--quantize --calibration_features`): the top-1 of the
  native model on the example clips.
"""
import os
import wave

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from tpu_speech_commands.export import saved_model as jax_saved_model
from tpu_speech_commands.export.inference_loader import \
    load_inference_model as jax_load
from tpu_speech_commands.export.keras_interop import \
    load_keras_h5_weights as jax_h5_weights
from tpu_speech_commands_torch import export_model
from tpu_speech_commands_torch.checkpoints import load_checkpoint
from tpu_speech_commands_torch.export import saved_model
from tpu_speech_commands_torch.export.inference_loader import \
    load_inference_model
from tpu_speech_commands_torch.export.keras_interop import (build_keras_model,
                                                            export_keras_h5,
                                                            import_h5_checkpoint)
from tpu_speech_commands_torch.models import init_model, input_shape
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.streaming import Listener
from tpu_speech_commands_torch.training.checkpoints import (flatten_variables,
                                                            save_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES_PATH = os.path.join(REPO, "configs", "direction_classes.txt")
CLASSES = ["background", "left", "right"]


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """Checkpoint loads write the port's own `pr`, which tests/conftest.py
    does not restore: snapshot and restore it here."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _fresh(tmp_path, model_type: str, seed: int = 5) -> str:
    _, variables = init_model(model_type, len(CLASSES), seed=seed)
    path = str(tmp_path / f"{model_type}.npz")
    save_checkpoint(path, variables, {"model_type": model_type,
                                      "num_classes": len(CLASSES),
                                      "classes": CLASSES})
    return path


@pytest.mark.parametrize(
    "model_type", ["simple_cnn", "simple_cnn_lite", "simple_gru",
                   "simple_lstm"])
def test_h5_import_scores_equal_keras(model_type, tmp_path):
    """A reference-architecture Keras model -> h5 -> import_h5_checkpoint
    -> the port's model on the CPU scores as Keras does."""
    keras_model = build_keras_model(model_type, 5)
    h5 = str(tmp_path / "model.h5")
    keras_model.save(h5)
    x = np.random.default_rng(0).standard_normal(
        (4,) + input_shape(model_type)).astype(np.float32)
    want = np.asarray(keras_model(x, training=False))
    ckpt = import_h5_checkpoint(h5, model_type, 5, str(tmp_path / "m.npz"),
                                classes=CLASSES + ["up", "down"])
    predict, fmt = load_inference_model(ckpt, "cpu")
    assert fmt == "NATIVE" and predict.classes[-1] == "down"
    np.testing.assert_allclose(predict(x).numpy(), want, rtol=1e-4,
                               atol=1e-5)
    # the same tensors as the JAX package's reader of the h5
    flat = flatten_variables(load_checkpoint(ckpt)[0])
    theirs = flatten_variables(jax_h5_weights(h5, model_type, 5))
    assert sorted(flat) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(flat[key], np.asarray(value))


@pytest.mark.parametrize("model_type", ["simple_cnn_lite", "simple_gru"])
def test_export_keras_h5_round_trip(model_type, tmp_path):
    ckpt = _fresh(tmp_path, model_type)
    out = export_keras_h5(ckpt, str(tmp_path / "m"))
    assert out.endswith(".h5")
    x = np.random.default_rng(1).standard_normal(
        (3,) + input_shape(model_type)).astype(np.float32)
    want = load_inference_model(ckpt, "cpu")[0](x).numpy()
    reloaded = tf.keras.models.load_model(out, compile=False)
    np.testing.assert_allclose(np.asarray(reloaded(x, training=False)), want,
                               rtol=1e-4, atol=1e-5)
    predict, fmt = load_inference_model(out)
    assert fmt == "H5"
    np.testing.assert_allclose(predict(x), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model_type", ["simple_cnn_lite", "simple_gru"])
def test_tf_exports_score_as_jax(model_type, tmp_path):
    """SavedModel, TFLite and frozen pb, each exported by the port and by
    the JAX package from one checkpoint, loaded by each package's loader."""
    ckpt = _fresh(tmp_path, model_type)
    x = np.random.default_rng(2).standard_normal((3, 30, 20)).astype(
        np.float32)
    cases = (("saved_model", "SAVED_MODEL", "export_saved_model", 1e-4, 1e-5),
             ("m.tflite", "TFLITE", "export_tflite", 1e-3, 1e-4),
             ("m.pb", "PB", "export_frozen_pb", 1e-4, 1e-5))
    for name, fmt, fn, rtol, atol in cases:
        ours = getattr(saved_model, fn)(ckpt, str(tmp_path / "port" / name))
        theirs = getattr(jax_saved_model, fn)(ckpt,
                                              str(tmp_path / "jax" / name))
        got, got_fmt = load_inference_model(ours)
        want, want_fmt = jax_load(theirs)
        assert got_fmt == want_fmt == fmt
        np.testing.assert_allclose(got(x), want(x), rtol=rtol, atol=atol,
                                   err_msg=fmt)
    for side in ("port", "jax"):
        with open(tmp_path / side / "classes.txt") as f:
            assert f.read().split() == CLASSES
    ref = load_inference_model(ckpt, "cpu")[0](x).numpy()
    np.testing.assert_allclose(got(x), ref, rtol=1e-4, atol=1e-5)


def _pcm(name: str) -> np.ndarray:
    with wave.open(os.path.join(REPO, "example", name), "rb") as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), "<i2")


def test_listener_on_port_tflite_and_int8(tmp_path):
    """A Listener on the port's .tflite of the shipped GRU scores each
    chunk as the native Listener does; the int8 TFLite of the shipped
    simple_cnn_lite from the export entry point (calibrated on those
    chunks' features) keeps the native top-1 on them.  (TFLite's
    calibrator crashes on the recurrent graph, so the int8 case is a
    CNN's, as in tests/test_export.py.)"""
    ckpt = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")
    tfl = saved_model.export_tflite(ckpt, str(tmp_path / "gru.tflite"))
    listeners = [Listener(model_path=p, classes_path=CLASSES_PATH,
                          device="cpu") for p in (ckpt, tfl)]
    assert listeners[1].model_format == "TFLITE"
    pcm = np.concatenate([_pcm("left_1.wav"), _pcm("up_2.wav")])
    events = [[], []]
    feats = []
    for lo in range(0, len(pcm) - 1023, 1024):
        chunk = pcm[lo:lo + 1024].tobytes()
        scores = [listener.process_chunk(chunk) for listener in listeners]
        np.testing.assert_allclose(scores[1], scores[0], rtol=1e-3,
                                   atol=1e-4)
        for i, listener in enumerate(listeners):
            index = int(np.argmax(scores[i]))
            score = float(scores[i][index])
            if index:
                score = listener.threshold_decoder.decode(score)
            if listener.detector.update(index, score):
                events[i].append((lo // 1024, index))
        feats.append(listeners[1].state["feats"].numpy().copy())
    assert events[0] == events[1] and [i for _, i in events[0]] == [1, 3]

    feats = np.stack(feats)
    np.save(tmp_path / "feats.npy", feats)
    lite = os.path.join(REPO, "pretrained", "direction_simple_cnn_lite.npz")
    q8 = export_model.main(["--checkpoint", lite, "--format", "tflite",
                            "--quantize", "--calibration_features",
                            str(tmp_path / "feats.npy"), "--output_path",
                            str(tmp_path / "lite_q8.tflite")])
    q8_predict, _ = load_inference_model(q8)
    native = load_inference_model(lite, "cpu")[0](feats).numpy()
    assert (q8_predict(feats).argmax(-1) == native.argmax(-1)).mean() >= 0.9
