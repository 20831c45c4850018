"""The port's tools layer against the JAX package's tools, on the CPU.

- `frontend/numpy_ref.py` against the JAX oracle on seeded audio: mfcc and
  bark, with and without deltas, at two configs (the same float64 numpy
  algorithm: atol 1e-9);
- `validate_speech_commands.validate` against the JAX tool's on the
  example clips for one `.npz`: the same top-k names, scores within atol
  1e-5 (the plain f32 frontend and model against XLA's);
- `dump_inference_model` against the JAX tool, key for key: equal arrays
  and equal metadata;
- `mfcc_feature` and `plot_spectrogram` on the CPU, against the oracle;
- `dev/bench_postprocess`: the scalar and vector paths fire the JAX tool's
  trigger counts on the same scores;
- `dev/bench_train` on the CPU at a tiny batch: its JSON line and keys;
- `MetricsLogger`: TensorBoard scalars equal to metrics.csv through
  tf.summary and through torch.utils.tensorboard, one printed line where
  neither imports, and no event file with `log_tensorboard=False`.

The accuracy-parity stage has its own file, `tests/test_torch_parity.py`.
"""
import csv
import glob
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from tpu_speech_commands.frontend import numpy_ref as jax_ref
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands_torch.dev import (FAST_MATH_ORACLE_ATOL, FEAT_ATOL,
                                         FEAT_RTOL)
from tpu_speech_commands_torch.frontend import numpy_ref
from tpu_speech_commands_torch.params import ListenerParams, pr
from tpu_speech_commands_torch.training.trainer import (EpochMetrics,
                                                        MetricsLogger)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")
CLASSES_PATH = os.path.join(REPO, "configs", "direction_classes.txt")
WAVS = sorted(glob.glob(os.path.join(REPO, "example", "*.wav")))
CONFIGS = {"default": {},
           "alt": {"n_fft": 512, "window_t": 0.03, "hop_t": 0.015,
                   "n_filt": 26, "n_mfcc": 13}}


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _load_tool(rel_path: str, name: str):
    """A JAX tool module loaded by file path, without its compilation
    cache."""
    from tpu_speech_commands.utils import compilation_cache as cc

    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "enable_compilation_cache", lambda *a, **k: None)
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, rel_path))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    return module


@pytest.mark.parametrize("use_delta", [False, True])
@pytest.mark.parametrize("frontend", ["mfcc", "bark"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_numpy_ref_matches_jax(config, frontend, use_delta):
    """audio_to_feature (and the log-mel spectrogram) of seeded audio, one
    short clip (left-padded) and one long (truncated): the JAX oracle's
    values within atol 1e-9."""
    kw = dict(CONFIGS[config], use_delta=use_delta)
    p, jp = ListenerParams(**kw), JaxParams(**kw)
    rng = np.random.default_rng(5)
    for n in (11000, 17000):
        audio = 0.3 * rng.standard_normal(n)
        got = numpy_ref.audio_to_feature(audio, p, frontend)
        want = jax_ref.audio_to_feature(audio, jp, frontend)
        assert got.shape == want.shape == (p.n_features, p.feature_size)
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    mels, powers = numpy_ref.mel_spec(audio, p.sample_rate,
                                      (p.window_samples, p.hop_samples),
                                      p.n_fft, p.n_filt)
    jmels, jpowers = jax_ref.mel_spec(audio, jp.sample_rate,
                                      (jp.window_samples, jp.hop_samples),
                                      jp.n_fft, jp.n_filt)
    np.testing.assert_allclose(mels, jmels, atol=1e-9, rtol=0)
    np.testing.assert_allclose(powers, jpowers, atol=1e-9, rtol=1e-12)


def test_validator_matches_jax_tool(tmp_path, capsys):
    """validate() on the eight clips, top 3, the simple_gru `.npz` on the
    CPU: each clip's class names equal the JAX tool's and the scores lie
    within atol 1e-5; the top-1 is the clip's label; a .txt a clip."""
    from tpu_speech_commands.params import pr as jax_pr
    from tpu_speech_commands_torch import validate_speech_commands as port
    from tpu_speech_commands_torch.utils import get_classes

    jax_tool = _load_tool("tools/evaluation/validate_speech_commands.py",
                          "_jax_validate_speech_commands")
    classes = get_classes(CLASSES_PATH)
    jax_snap = jax_pr.to_dict()
    try:
        want = jax_tool.validate(CKPT, WAVS, classes, top_k=3, loop_count=2)
    finally:
        jax_pr.override(jax_snap)
    got = port.main(["--model_path", CKPT, "--audio_path",
                     os.path.join(REPO, "example"), "--classes_path",
                     CLASSES_PATH, "--top_k", "3", "--loop_count", "2",
                     "--output_path", str(tmp_path), "--device", "cpu"])
    assert len(got) == len(want) == 8
    for wav, g, w in zip(WAVS, got, want):
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=1e-5, rtol=0)
        assert g[0][0] == os.path.basename(wav).split("_")[0]
        name = os.path.splitext(os.path.basename(wav))[0]
        lines = (tmp_path / f"{name}.txt").read_text().splitlines()
        assert lines[0] == f"{wav}:" and len(lines) == 4
    assert "Loaded NATIVE model" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["classes", "params_and_type"])
def test_dump_inference_model_matches_jax_tool(tmp_path, monkeypatch, case):
    """The same training checkpoint through both tools: the same keys,
    equal arrays and equal metadata."""
    from tpu_speech_commands.params import pr as jax_pr
    from tpu_speech_commands.training.checkpoints import (
        load_checkpoint as jax_load)
    from tpu_speech_commands_torch import dump_inference_model as port
    from tpu_speech_commands_torch.models import init_model
    from tpu_speech_commands_torch.training.checkpoints import save_checkpoint

    model, _ = init_model("simple_cnn_lite", 5, seed=3)
    src = str(tmp_path / "train.npz")
    save_checkpoint(src, model, {"model_type": "simple_cnn_lite",
                                 "num_classes": 5, "epoch": 7})
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"n_mfcc": 13, "n_filt": 26}))
    if case == "classes":
        flags = ["--classes_path", CLASSES_PATH]
    else:
        flags = ["--model_type", "simple_cnn_lite", "--params_path",
                 str(params)]
    jax_tool = _load_tool("tools/misc/dump_inference_model.py",
                          "_jax_dump_inference_model")
    jax_out, port_out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_snap = jax_pr.to_dict()
    monkeypatch.setattr(sys, "argv", ["dump", "--checkpoint", src,
                                      "--output_file", jax_out, *flags])
    try:
        jax_tool.main()
    finally:
        jax_pr.override(jax_snap)
    port.main(["--checkpoint", src, "--output_file", port_out, *flags])
    with np.load(jax_out) as j, np.load(port_out) as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            if key != "__meta__":
                np.testing.assert_array_equal(t[key], j[key])
    (_, want_meta), (_, got_meta) = jax_load(jax_out), jax_load(port_out)
    assert got_meta == want_meta
    assert got_meta["num_classes"] == 5 and "params" in got_meta


def test_mfcc_feature_and_plot_on_cpu(tmp_path):
    """mfcc_feature on one clip, on the CPU: the f32 legs within the f32
    feature bound of the float64 oracle, the fast_math leg within its
    bf16 bound, the C++ library's within the f32 bound; a text dump a
    leg.  plot_spectrogram writes its png from the oracle's features.
    (The fast_math bound, `dev.FAST_MATH_ORACLE_ATOL`, is 2.4x the largest
    distance on the eight example clips.)"""
    from tpu_speech_commands_torch import mfcc_feature, plot_spectrogram

    wav = os.path.join(REPO, "example", "left_1.wav")
    res = mfcc_feature.main(["--audio_file", wav, "--device", "cpu",
                             "--output_path", str(tmp_path / "dump")])
    oracle = res["numpy_oracle"]
    assert oracle.shape == (pr.n_features, pr.n_mfcc)
    assert res["frontend_kernel_path"] == "torch"
    assert res["fast_math_kernel_path"] == "torch"
    for leg in ("torch_cpu", "frontend_kernel", "native_cpp"):
        assert np.isfinite(res[leg]).all()
        np.testing.assert_allclose(res[leg], oracle, atol=FEAT_ATOL,
                                   rtol=FEAT_RTOL)
    np.testing.assert_allclose(res["fast_math_kernel"], oracle,
                               atol=FAST_MATH_ORACLE_ATOL, rtol=0)
    for leg in ("numpy_oracle", "torch_cpu", "frontend_kernel",
                "fast_math_kernel", "native_cpp"):
        dumped = np.loadtxt(tmp_path / "dump" / f"mfcc_{leg}.txt")
        np.testing.assert_allclose(dumped, res[leg], atol=1e-6)
    png = str(tmp_path / "left_1.png")
    mels, feats = plot_spectrogram.main(["--audio_file", wav,
                                         "--output_file", png])
    assert os.path.getsize(png) > 0
    np.testing.assert_array_equal(feats, oracle)
    assert mels.shape[1] == pr.n_filt


@pytest.mark.parametrize("n_slots", [1, 1024])
def test_bench_postprocess_counts_match_jax_tool(n_slots):
    """The scalar loop and the vector step on 20 ticks of the same scores:
    each fires the JAX tool's trigger count (and at least one trigger at
    1024 slots)."""
    from tpu_speech_commands.params import pr as jax_pr
    from tpu_speech_commands.streaming import (
        ThresholdDecoder as JaxDecoder, TriggerDetector as JaxTrigger,
        TriggerDetectorArray as JaxArray)
    from tpu_speech_commands_torch.dev import bench_postprocess as port
    from tpu_speech_commands_torch.streaming import (
        ThresholdDecoder, TriggerDetector, TriggerDetectorArray)

    jax_tool = _load_tool("tools/evaluation/bench_postprocess.py",
                          "_jax_bench_postprocess")
    rng = np.random.default_rng(0)
    seq = [port.synth_scores(rng, n_slots, 5) for _ in range(20)]
    classes = port.CLASSES
    counts = []
    for tool, dec, trig, arr, p in (
            (jax_tool, JaxDecoder, JaxTrigger, JaxArray, jax_pr),
            (port, ThresholdDecoder, TriggerDetector, TriggerDetectorArray,
             pr)):
        decoder = dec(p.threshold_config, p.threshold_center)
        triggers = [trig(1024, classes) for _ in range(n_slots)]
        detector = arr(1024, classes, n_slots=n_slots)
        counts.append(
            (sum(tool.run_scalar(decoder, triggers, s) for s in seq),
             sum(tool.run_vector(decoder, detector, s) for s in seq)))
    (js, jv), (ps, pv) = counts
    assert ps == pv == js == jv
    assert n_slots == 1 or ps > 0
    row = port.bench(n_slots, ticks=5)
    assert row["fired"] >= 0 and row["scalar_ms"] > 0 and row["vector_ms"] > 0


def test_bench_train_on_cpu(capsys):
    """bench_train on the CPU at batch 4, two steps, features and
    --augment, and the fit loop for simple_gru: one JSON line with the
    keys, finite losses, positive rates."""
    from tpu_speech_commands_torch.dev import bench_train

    bench_train.main(["--models", "simple_gru,simple_cnn_lite",
                      "--batch_size", "4", "--iters", "2", "--device", "cpu",
                      "--fit", "--fit_samples", "16", "--fit_epochs", "2",
                      "--fit_batch", "8"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = result["bench_train"]
    assert [r["model_type"] for r in rows] == ["simple_gru", "simple_cnn_lite"]
    for row in rows:
        assert {"batch_size", "iters", "device", "input", "step_ms",
                "samples_per_s", "loss", "fit_samples_per_s",
                "fit_step_samples_per_s"} <= set(row)
        assert row["device"] == "cpu" and row["input"] == "features"
        assert np.isfinite(row["loss"]) and row["samples_per_s"] > 0
    aug = bench_train.bench_model("simple_gru", 4, iters=1, device="cpu",
                                  augment=True, warmup=1)
    assert aug["frontend"] == "torch" and 0 < aug["frontend_share"]
    assert np.isfinite(aug["loss"])


def _event_scalars(log_dir: str) -> dict:
    """{tag: {step: value}} from every event file under log_dir."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util

    out = {}
    for path in glob.glob(os.path.join(log_dir, "events.out.tfevents.*")):
        for event in EventFileLoader(path).Load():
            for v in event.summary.value:
                value = (v.simple_value if v.HasField("simple_value")
                         else float(tensor_util.make_ndarray(v.tensor)))
                out.setdefault(v.tag, {})[event.step] = value
    return out


@pytest.mark.parametrize("writer", ["tensorflow", "torch", "none"])
def test_metrics_logger_tensorboard(tmp_path, monkeypatch, capsys, writer):
    """Two epochs logged: with TensorFlow (tf.summary) or only tensorboard
    (torch.utils.tensorboard), the event scalars loss, accuracy, val_loss,
    val_accuracy and lr at step `epoch` equal metrics.csv's values (f32);
    with neither importable, one printed line and the CSV alone."""
    if writer != "tensorflow":
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    if writer == "none":
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricsLogger(str(tmp_path))
    for epoch, lr in ((1, 1e-3), (2, 5e-4)):
        logger.log(EpochMetrics(epoch=epoch, loss=1.5 / epoch,
                                accuracy=0.25 * epoch, val_loss=1.25 / epoch,
                                val_accuracy=0.2 * epoch, seconds=0.5, lr=lr))
    logger.close()
    with open(tmp_path / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    scalars = _event_scalars(str(tmp_path))
    printed = capsys.readouterr().out
    if writer == "none":
        assert scalars == {} and "TensorBoard log off" in printed
        return
    assert "TensorBoard log off" not in printed
    assert set(scalars) == {"loss", "accuracy", "val_loss", "val_accuracy",
                            "lr"}
    for row in rows:
        for tag, by_step in scalars.items():
            np.testing.assert_allclose(by_step[int(row["epoch"])],
                                       float(row[tag]), rtol=1e-6)


def test_fit_without_tensorboard_writes_no_events(tmp_path):
    """Trainer.fit with log_tensorboard=False: metrics.csv and no event
    file."""
    from tpu_speech_commands_torch.data.dataset import Dataset
    from tpu_speech_commands_torch.models import init_model
    from tpu_speech_commands_torch.optim import get_optimizer
    from tpu_speech_commands_torch.training import Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    ds = Dataset(rng.standard_normal((8, 30, 20)).astype(np.float32),
                 rng.integers(0, 3, 8).astype(np.int32))
    model, _ = init_model("simple_gru", 3, seed=0)
    cfg = TrainerConfig(batch_size=8, epochs=1, log_dir=str(tmp_path),
                        log_tensorboard=False)
    Trainer(model, get_optimizer("adam", 1e-3), "simple_gru", 3, cfg,
            device="cpu").fit(ds, ds, verbose=False)
    assert os.path.exists(tmp_path / "metrics.csv")
    assert not glob.glob(str(tmp_path / "events.out.tfevents.*"))
