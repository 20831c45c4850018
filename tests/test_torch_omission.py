"""The port's stage cuts (`ops/omission_kernel.py`) against the JAX
stage-omission profile and a float64 oracle, run on the CPU.

- `truncated_plain`, the plain version both cut kernels (csrc/ct_frontend.cu,
  csrc/mfcc_frontend.cu) are held to on the card, against the JAX builder
  `tools/dev/r3_omission.py::make_truncated` (loaded by file path, its
  import-time `enable_compilation_cache()` made a no-op first) under
  `force_tpu_interpret_mode()`: all 7 stages, streamed and constant-block,
  on seeded numpy f32 audio at B = 32 (two tiles, so the i mod 16 mapping of
  the constant block shows) and gain 1.3, and int16 PCM at `full`.
  Tolerance atol 1e-4 / rtol 1e-4: f32 math in another order on both sides.
  Every stage's 30-frame sums fit it: the largest lane, the mel energy
  (~2.7e4), is held by its rtol.
- the same plain version against a float64 numpy oracle built on
  `np.fft.rfft` (natural-order bins, then the CT split's permuted fold), for
  every stage of FFT_STAGES: the contract the FFT kernel is held to.  The
  plain version is f32 with f32 constants: atol 1e-3 / rtol 1e-4 (the
  energy lane sums 15,390 powers; the sums' relative error is ~1e-6).
The kernels against the plain version, on the card: test_torch_gpu.py.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_speech_commands_torch.frontend.filterbanks import (dct_t_matrix,
                                                            filterbank_matrix)
from tpu_speech_commands_torch.ops import omission_kernel as om
from tpu_speech_commands_torch.params import ListenerParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-4
ORACLE_ATOL, ORACLE_RTOL = 1e-3, 1e-4
GAIN = 1.3


@pytest.fixture(scope="module")
def jax_omission():
    """tools/dev/r3_omission.py, loaded by file path."""
    import tpu_speech_commands.utils.compilation_cache as cc

    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "enable_compilation_cache", lambda *a, **k: None)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_dev_r3_omission",
            os.path.join(REPO, "tools", "dev", "r3_omission.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    return module


@pytest.fixture(scope="module")
def audio32():
    return np.random.default_rng(21).standard_normal((32, 16000)).astype(
        np.float32)


@pytest.fixture(scope="module")
def consts():
    return om.TruncatedConstants(ListenerParams(), "cpu")


@pytest.mark.parametrize("constant_block", [False, True],
                         ids=["streamed", "constant_block"])
@pytest.mark.parametrize("stage", om.STAGES)
def test_plain_matches_the_jax_cut(jax_omission, audio32, consts, stage,
                                   constant_block):
    fn = jax_omission.make_truncated(stage, constant_block=constant_block)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(audio32), GAIN))
    got = om.truncated_plain(torch.tensor(audio32), GAIN, ListenerParams(),
                             stage, constant_block, consts.ct).numpy()
    assert got.shape == want.shape == (32, 128)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_matches_the_jax_cut_on_int16(jax_omission, consts):
    pcm = np.clip(np.random.default_rng(22).standard_normal((32, 16000)) * 6000,
                  -32768, 32767).astype(np.int16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_omission.make_truncated("full")(jnp.asarray(pcm),
                                                              GAIN))
    got = om.truncated_plain(torch.tensor(pcm), GAIN, ListenerParams(), "full",
                             consts=consts.ct).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _oracle(audio: np.ndarray, gain: float, stage: str) -> np.ndarray:
    """float64: natural-order rfft bins, folded as the CT split folds them."""
    p = ListenerParams()
    x = audio.astype(np.float64) * gain
    if stage == "load":
        return x[:, :128] + x[:, -128:]
    n_frames = 1 + (x.shape[1] - p.n_fft) // p.hop_samples
    frames = np.stack([x[:, t * p.hop_samples:t * p.hop_samples + p.n_fft]
                       for t in range(n_frames)], 1)  # (B, T, 1024)
    if stage == "framing":
        return frames.reshape(*frames.shape[:2], 8, 128).sum((1, 2))
    spec = np.fft.rfft(frames, axis=-1) / np.sqrt(p.n_fft)  # (B, T, 513)
    power = np.abs(spec) ** 2
    if stage == "power":
        col = np.arange(p.n_fft // 2)
        perm = 8 * (col % 64) + col // 64  # column s 64 + j <-> bin 8 j + s
        rows = power[..., perm].reshape(*power.shape[:2], 4, 128).sum(2)
        return (rows + spec[..., 512:513].real).sum(1)
    filt = filterbank_matrix(p, "mfcc").astype(np.float64)  # (513, 20)
    mel = np.zeros(power.shape[:2] + (128,))
    mel[..., :20] = power @ filt
    mel[..., 20] = power.sum(-1)
    if stage == "mel":
        return mel.sum(1)
    logs = np.log(np.maximum(mel, 2.220446049250313e-16))
    if stage == "log":
        return logs.sum(1)
    out = np.zeros_like(logs)
    out[..., 0] = logs[..., 20]
    out[..., 1:20] = (logs[..., :20] @ dct_t_matrix(20).astype(np.float64))[..., 1:]
    return out.sum(1)


@pytest.mark.parametrize("stage", om.FFT_STAGES)
def test_plain_matches_the_float64_rfft_oracle(audio32, consts, stage):
    got = om.truncated_plain(torch.tensor(audio32), GAIN, ListenerParams(),
                             stage, consts=consts.ct).numpy()
    np.testing.assert_allclose(got, _oracle(audio32, GAIN, stage),
                               rtol=ORACLE_RTOL, atol=ORACLE_ATOL)


def test_constant_block_reads_row_i_mod_16(audio32, consts):
    p = ListenerParams()
    audio = torch.tensor(audio32)
    got = om.truncated_plain(audio, GAIN, p, "power", True, consts.ct)
    want = om.truncated_plain(audio[:16], GAIN, p, "power", False, consts.ct)
    torch.testing.assert_close(got, torch.cat([want, want]), rtol=0, atol=0)


@pytest.mark.parametrize("kernel", sorted(om.KERNELS))
def test_dispatcher_on_cpu_is_the_plain_version(audio32, consts, kernel):
    p = ListenerParams()
    audio = torch.tensor(audio32[:16])
    for stage in om.KERNELS[kernel]:
        got = om.truncated(audio, 0.7, consts, p, stage, kernel, True)
        torch.testing.assert_close(
            got, om.truncated_plain(audio, 0.7, p, stage, True, consts.ct),
            rtol=0, atol=0)
    launch = om.ct_truncated_cuda if kernel == "ct" else om.fft_truncated_cuda
    c = consts.ct if kernel == "ct" else consts.fft
    with pytest.raises(ValueError, match="audio on cpu"):
        launch(audio, torch.ones(1), c, p, "full")


def test_refusals(audio32, consts):
    p = ListenerParams()
    audio = torch.tensor(audio32)
    with pytest.raises(ValueError, match="multiple of 16"):
        om.truncated(audio[:24], None, consts, p, "full")
    with pytest.raises(ValueError, match="n2 = 8"):
        om.truncated_plain(audio, None, ListenerParams(n_fft=768,
                                                       window_t=0.048), "mel")
    with pytest.raises(ValueError, match="n2 = 8"):
        om.truncated_plain(audio, None, ListenerParams(hop_t=0.016), "mel")
    with pytest.raises(ValueError, match="n2 = 8"):
        om.TruncatedConstants(ListenerParams(n_fft=768, window_t=0.048), "cpu")
    with pytest.raises(ValueError, match="unknown stage"):
        om.truncated(audio, None, consts, p, "dct")
    with pytest.raises(ValueError, match="unknown stage 'butterfly' for the fft"):
        om.truncated(audio, None, consts, p, "butterfly", "fft")
    with pytest.raises(ValueError, match="unknown stage 'butterfly' for the fft"):
        om.fft_truncated_cuda(audio, torch.ones(1), consts.fft, p, "butterfly")
    with pytest.raises(ValueError, match=r"\(B, 16000\)"):
        om.truncated(audio[:, :8000], None, consts, p, "load")
    assert "n_filt < 128" in om.truncated_config_error(
        ListenerParams(n_filt=128, n_mfcc=20))
    assert "multiple of 4, got 15998" in om.truncated_config_error(
        ListenerParams(buffer_t=0.9999))
    assert om.truncated_config_error(ListenerParams()) is None
