"""The port imports no jax or flax, not even transitively.

Run in a fresh interpreter (this test process has jax loaded through
conftest): import every module of tpu_speech_commands_torch and
chip_smoke.py, then list what reached sys.modules.
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
print(json.dumps({
    "modules": names,
    "leaked": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")),
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
        "tpu_speech_commands_torch.ops._build",
        "tpu_speech_commands_torch.export.inference_loader",
        "tpu_speech_commands_torch.frontend.dsp",
        "tpu_speech_commands_torch.models.rnn",
        "tpu_speech_commands_torch.convert",
        "tpu_speech_commands_torch.checkpoints",
    }
    assert expected <= set(result["modules"])
    assert result["leaked"] == []
