"""The port imports no jax or flax, and nothing of the JAX package
`tpu_speech_commands`, not even transitively; and importing it loads no
TensorFlow, Keras, h5py, onnxruntime or pyaudio (the export layer and the
audio tools import them inside the functions that need them).

Run in a fresh interpreter (this test process has jax loaded through
conftest): import every module of tpu_speech_commands_torch and
chip_smoke.py, run the `--help` of the export and statistics entry points,
of the pyaudio tools and of `dev.make_pretrained`, then list what reached
sys.modules; then start one rank through the port's launcher
(`parallel.launch`, a spawned child on the CPU) and read the modules the
child loaded from its report.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import tpu_speech_commands_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
import contextlib, io, runpy
for entry in ("export_model", "model_statistics", "audio_process.audio_play",
              "audio_process.audio_record", "audio_process.wav_play",
              "dev.make_pretrained"):
    sys.argv = [entry, "--help"]
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            runpy.run_module("tpu_speech_commands_torch." + entry,
                             run_name="__main__")
        except SystemExit:
            pass
import tempfile
from tpu_speech_commands_torch.dev.dryrun_multichip import write_rank_report
from tpu_speech_commands_torch.parallel.launch import launch
with tempfile.TemporaryDirectory() as out:
    launch(write_rank_report, ["cpu"], args=(out,))
    with open(out + "/rank0.json") as f:
        child = json.load(f)
print(json.dumps({
    "child": child["foreign_modules"],
    "modules": names,
    "leaked": sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "tpu_speech_commands",
        "tensorflow", "keras", "h5py", "onnxruntime", "pyaudio")),
}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {
        "tpu_speech_commands_torch.serving",
        "tpu_speech_commands_torch.ops.frontend_kernel",
        "tpu_speech_commands_torch.ops.rnn_kernel",
        "tpu_speech_commands_torch.ops.gru_plan",
        "tpu_speech_commands_torch.ops.lstm_plan",
        "tpu_speech_commands_torch.dev.gru_ablation",
        "tpu_speech_commands_torch.dev.lstm_ablation",
        "tpu_speech_commands_torch.ops._build",
        "tpu_speech_commands_torch.export.inference_loader",
        "tpu_speech_commands_torch.frontend.dsp",
        "tpu_speech_commands_torch.models.rnn",
        "tpu_speech_commands_torch.models.cnn",
        "tpu_speech_commands_torch.ops.cnn_lowering",
        "tpu_speech_commands_torch.ops.cnn_kernel",
        "tpu_speech_commands_torch.convert",
        "tpu_speech_commands_torch.checkpoints",
        "tpu_speech_commands_torch.params",
        "tpu_speech_commands_torch.device",
        "tpu_speech_commands_torch.ops.dense_dft_kernel",
        "tpu_speech_commands_torch.ops.load_kernel",
        "tpu_speech_commands_torch.dev",
        "tpu_speech_commands_torch.dev.pallas_experiments",
        "tpu_speech_commands_torch.dev.r3_experiments",
        "tpu_speech_commands_torch.dev.r4_mxu_stage1",
        "tpu_speech_commands_torch.dev.r3_frontend_variants",
        "tpu_speech_commands_torch.dev.r3_stage2",
        "tpu_speech_commands_torch.dev.r3_widecell",
        "tpu_speech_commands_torch.dev.ct_ablation",
        "tpu_speech_commands_torch.dev.fft_ablation",
        "tpu_speech_commands_torch.dev.mixed_ablation",
        "tpu_speech_commands_torch.dev.wide_ablation",
        "tpu_speech_commands_torch.dev.source_ab",
        "tpu_speech_commands_torch.ops.fft_plan",
        "tpu_speech_commands_torch.ops.ct_constants",
        "tpu_speech_commands_torch.ops.ct_kernel",
        "tpu_speech_commands_torch.ops._checks",
        "tpu_speech_commands_torch.ops.omission_kernel",
        "tpu_speech_commands_torch.dev.r3_omission",
        "tpu_speech_commands_torch.utils.common",
        "tpu_speech_commands_torch.data.wav",
        "tpu_speech_commands_torch.data.synthetic",
        "tpu_speech_commands_torch.data.dataset",
        "tpu_speech_commands_torch.data.augment",
        "tpu_speech_commands_torch.evaluation.evaluate",
        "tpu_speech_commands_torch.eval",
        "tpu_speech_commands_torch.train",
        "tpu_speech_commands_torch.losses",
        "tpu_speech_commands_torch.optim",
        "tpu_speech_commands_torch.ops.training_frontend",
        "tpu_speech_commands_torch.training.checkpoints",
        "tpu_speech_commands_torch.training.trainer",
        "tpu_speech_commands_torch.training.averaging",
        "tpu_speech_commands_torch.streaming",
        "tpu_speech_commands_torch.streaming.decoder",
        "tpu_speech_commands_torch.streaming.trigger",
        "tpu_speech_commands_torch.streaming.feature_stream",
        "tpu_speech_commands_torch.streaming.listener",
        "tpu_speech_commands_torch.listen",
        "tpu_speech_commands_torch.stream_server",
        "tpu_speech_commands_torch.dev.bench_streaming",
        "tpu_speech_commands_torch.export.native_format",
        "tpu_speech_commands_torch.export.onnx_writer",
        "tpu_speech_commands_torch.export.onnx_runtime_mini",
        "tpu_speech_commands_torch.export.keras_interop",
        "tpu_speech_commands_torch.export.saved_model",
        "tpu_speech_commands_torch.native_binding",
        "tpu_speech_commands_torch.utils.native_build",
        "tpu_speech_commands_torch.evaluation.statistics",
        "tpu_speech_commands_torch.export_model",
        "tpu_speech_commands_torch.model_statistics",
        "tpu_speech_commands_torch.parallel",
        "tpu_speech_commands_torch.parallel.mesh",
        "tpu_speech_commands_torch.parallel.tensor_parallel",
        "tpu_speech_commands_torch.parallel.launch",
        "tpu_speech_commands_torch.dev.dryrun_multichip",
        "tpu_speech_commands_torch.dev.bench_multichip",
        "tpu_speech_commands_torch.frontend.numpy_ref",
        "tpu_speech_commands_torch.validate_speech_commands",
        "tpu_speech_commands_torch.dump_inference_model",
        "tpu_speech_commands_torch.mfcc_feature",
        "tpu_speech_commands_torch.plot_spectrogram",
        "tpu_speech_commands_torch.dev.accuracy_parity",
        "tpu_speech_commands_torch.dev.bench_train",
        "tpu_speech_commands_torch.dev.bench_postprocess",
        "tpu_speech_commands_torch.audio_process",
        "tpu_speech_commands_torch.audio_process._common",
        *(f"tpu_speech_commands_torch.audio_process.{tool}" for tool in (
            "add_noise", "annotation_update", "audio_convert", "audio_play",
            "audio_record", "audio_reverberation", "audio_split",
            "silent_check", "speech_command_split", "speech_duration_check",
            "split_channel", "vad_clip", "wav_check", "wav_filter",
            "wav_merge", "wav_play", "white_noise")),
        "tpu_speech_commands_torch.dev.make_pretrained",
        "tpu_speech_commands_torch.dev.bench_native",
        "tpu_speech_commands_torch.dev.make_chimes",
        "tpu_speech_commands_torch.plot_audio",
    }
    assert expected <= set(result["modules"])
    assert result["leaked"] == []
    assert result["child"] == []
