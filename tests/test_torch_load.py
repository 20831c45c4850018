"""The port's audio-read floor (`ops/load_kernel.py`) against the JAX
package's `tools/dev/r3_experiments.py::make_load_only`, run in TPU
interpret mode on the CPU.

`tools/dev` is not a package: the script is loaded by its file path, with
its import-time `enable_compilation_cache()` made a no-op first.  The
broadcast version replaces the `load_kernel` closure inside
`tools/dev/r4_mxu_stage1.py::main`, which cannot be reached without running
that TPU benchmark; it is held to the same row sum, broadcast.

Tolerance, per row: |err| <= 2e-6 * sum |gain * x|.  Both sides sum 16,000
f32 terms in another order (eps * log2(16000) ~ 8.4e-7 of the sum of
magnitudes); a bare atol would be wrong, the sums reach the hundreds.

The CUDA kernels against the plain versions on the card: test_torch_gpu.py.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_speech_commands_torch.dev import r3_experiments as port_r3
from tpu_speech_commands_torch.ops import load_kernel as L

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 2e-6
OUT_COLS = 600  # n_features x n_mfcc at the default config


@pytest.fixture(scope="module")
def jax_r3():
    import tpu_speech_commands.utils.compilation_cache as cc

    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "enable_compilation_cache", lambda *a, **k: None)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_dev_r3_experiments",
            os.path.join(REPO, "tools", "dev", "r3_experiments.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    return module


def _audio(batch=32, seed=0):
    # speech-like scale and a DC offset, so the sums are far from zero
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, 16000)) + 0.05).astype(np.float32)


def _assert_rowsum_close(got, want, audio, gain):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = REL * np.abs(np.float64(gain) * audio).sum(1, keepdims=True)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


# gain 1.5, and the iteration-dependent gains 1 + 1e-9 i of the JAX
# script's scan (computed in f32: 1 for i = 1, just above 1 for i = 1000)
GAINS = {"1.5": np.float32(1.5), "1+1e-9*1": np.float32(1) + np.float32(1e-9),
         "1+1e-9*1000": np.float32(1) + np.float32(1e-9) * np.float32(1000)}


@pytest.mark.parametrize("name", sorted(GAINS))
def test_rowsum_plain_matches_jax_load_only(jax_r3, name):
    gain = GAINS[name]
    audio = _audio()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_r3.make_load_only(16)(jnp.asarray(audio), gain))
    got = L.load_rowsum_plain(torch.tensor(audio), torch.tensor([gain]))
    assert got.shape == (32, 1) and got.dtype == torch.float32
    _assert_rowsum_close(got.numpy(), want, audio, gain)
    # and the dev entry point's make_load_only on the CPU: the plain version
    got = port_r3.make_load_only("cpu")(torch.tensor(audio), float(gain))
    _assert_rowsum_close(got.numpy(), want, audio, gain)


@pytest.mark.parametrize("name", sorted(GAINS))
def test_broadcast_plain_is_the_row_sum_broadcast(jax_r3, name):
    gain = GAINS[name]
    audio = _audio(seed=1)
    with pltpu.force_tpu_interpret_mode():
        rowsum = np.asarray(jax_r3.make_load_only(16)(jnp.asarray(audio), gain))
    got = L.load_broadcast_plain(torch.tensor(audio), float(gain), OUT_COLS)
    assert got.shape == (32, OUT_COLS) and got.is_contiguous()
    _assert_rowsum_close(got.numpy(), np.broadcast_to(rowsum, (32, OUT_COLS)),
                         audio, gain)
    assert (got == got[:, :1]).all()


def test_dispatchers_on_cpu_are_the_plain_versions():
    audio = torch.tensor(_audio(5, seed=2))
    torch.testing.assert_close(L.load_rowsum(audio, 1.5),
                               L.load_rowsum_plain(audio, 1.5), rtol=0, atol=0)
    torch.testing.assert_close(L.load_broadcast(audio, 1.5, 7),
                               L.load_broadcast_plain(audio, 1.5, 7),
                               rtol=0, atol=0)
    assert L.load_rowsum(audio[:0], 1.0).shape == (0, 1)


def test_raw_wrappers_refuse_what_they_cannot_take():
    audio = torch.tensor(_audio(2, seed=3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.load_rowsum_cuda(audio, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.load_broadcast_cuda(audio, 1.0, OUT_COLS)


def test_make_load_only_refuses_audio_on_another_device():
    with pytest.raises(ValueError, match="built for cpu"):
        port_r3.make_load_only("cpu")(torch.zeros(2, 16000, device="meta"), 1.0)


def test_gains_are_the_jax_scans_f32_gains():
    g = port_r3.gains(1000, "cpu").numpy()
    i = np.arange(1000, dtype=np.float32)
    np.testing.assert_array_equal(g, np.float32(1.0) + np.float32(1e-9) * i)
