"""The port's frontend against the JAX package and the golden fixture.

The same numpy audio, made from a seed, goes through the port's plain
PyTorch frontend (the plain version of the CUDA frontend kernel) and
through the JAX `Frontend` and the fused Pallas kernel in interpret mode
(ct and dense DFT modes).  Tolerances:
- vs JAX (dense DFT and Cooley-Tukey DFT, f32): rtol 1e-4 / atol 1e-4, the
  bound tests/test_pallas_frontend.py holds the two JAX paths to (measured
  gap ~3e-6);
- vs the golden fixture (the reference's C++ DSP in float64): rtol 1e-3 /
  atol 2e-3, the bound tests/test_frontend_jax.py holds JAX f32 to.

The CUDA kernel against the plain version on the card: test_torch_gpu.py.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.frontend import Frontend as JaxFrontend
from tpu_speech_commands.ops import make_fused_frontend
from tpu_speech_commands_torch.frontend import Frontend, add_deltas, frame_signal
from tpu_speech_commands_torch.ops import frontend_kernel
from tpu_speech_commands_torch.ops.frontend_kernel import (
    KernelConstants,
    MfccFrontend,
    kernel_config_error,
)
from tpu_speech_commands_torch.params import ListenerParams

RTOL, ATOL = 1e-4, 1e-4
GOLD_RTOL, GOLD_ATOL = 1e-3, 2e-3
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_mfcc.npz")

# name -> (ListenerParams kwargs, feature_type)
CONFIGS = {
    "mfcc": ({}, "mfcc"),
    "bark": ({}, "bark"),
    "use_delta": ({"use_delta": True}, "mfcc"),
    "window_t=0.05": ({"window_t": 0.05}, "mfcc"),  # zero-padded FFT
    "odd_hop": ({"hop_t": 0.03}, "mfcc"),  # 32 frames framed, 31 kept
    "bark_delta": ({"use_delta": True}, "bark"),
}


@pytest.fixture(scope="module")
def audio_batch():
    rng = np.random.default_rng(21)
    t = np.arange(16000) / 16000.0
    rows = [
        0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(16000)
        for f in (440, 300, 1200, 2500)
    ]
    return np.stack(rows).astype(np.float32)


def _port(p, feature_type, audio, gain=None):
    return Frontend(p, feature_type, "cpu")(torch.tensor(audio), gain).numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_matches_jax_frontend(audio_batch, name):
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    got = _port(p, feature_type, audio_batch)
    want = np.asarray(JaxFrontend(p, feature_type)(jnp.asarray(audio_batch)))
    assert got.shape == want.shape == (4, p.n_features, p.feature_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dft_mode", ["ct", "dense"])
@pytest.mark.parametrize("name", ["mfcc", "bark", "use_delta", "odd_hop"])
def test_plain_matches_pallas_interpret(audio_batch, name, dft_mode):
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    fused = make_fused_frontend(p, feature_type=feature_type, batch_tile=4,
                                interpret=True, dft_mode=dft_mode,
                                emit_deltas=p.use_delta)
    want = np.asarray(fused(jnp.asarray(audio_batch)))
    got = _port(p, feature_type, audio_batch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_matches_pallas_dense_zero_padded(audio_batch):
    """window_t=0.05 (800 of 1024 points): the CT path refuses it, the dense
    path zero-pads, as the port's frontend does."""
    p = ListenerParams(window_t=0.05)
    fused = make_fused_frontend(p, batch_tile=4, interpret=True,
                                dft_mode="dense")
    np.testing.assert_allclose(
        _port(p, "mfcc", audio_batch),
        np.asarray(fused(jnp.asarray(audio_batch))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gain", [None, 0.5, 1.7])
def test_int16_with_gain_matches_jax(audio_batch, gain):
    """int16 decodes as x/32768 BEFORE the gain, in both packages."""
    p = ListenerParams()
    pcm = np.clip(audio_batch * 32768.0, -32768, 32767).astype(np.int16)
    got = _port(p, "mfcc", pcm, gain)
    fused = make_fused_frontend(p, batch_tile=4, interpret=True)
    want = np.asarray(fused(jnp.asarray(pcm), gain))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    as_float = pcm.astype(np.float32) / 32768.0 * (1.0 if gain is None else gain)
    np.testing.assert_allclose(got, _port(p, "mfcc", as_float.astype(np.float32)),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURES)


def test_golden_default(golden):
    got = _port(ListenerParams(), "mfcc", golden["audio_default"][None])[0]
    assert got.shape == golden["mfcc_default"].shape == (30, 20)
    np.testing.assert_allclose(got, golden["mfcc_default"], rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)


def test_golden_padded(golden):
    """The C++ port short-circuits all-zero frames to zero vectors; the
    sonopy algorithm both packages follow does not: compare the rest."""
    audio = golden["audio_padded"]
    got = _port(ListenerParams(), "mfcc", audio[None])[0]
    frames = frame_signal(torch.tensor(audio), 1024, 512).numpy()
    mask = ~np.all(frames == 0, axis=1)
    assert mask.sum() > 10
    np.testing.assert_allclose(got[mask], golden["mfcc_padded"][mask],
                               rtol=GOLD_RTOL, atol=GOLD_ATOL)


def test_golden_alt_config(golden):
    sr, win, hop, nfft, nmfcc, nfilt = (int(v) for v in golden["alt_config"])
    p = ListenerParams(window_t=win / sr, hop_t=hop / sr, n_fft=nfft,
                       n_mfcc=nmfcc, n_filt=nfilt)
    assert (p.window_samples, p.hop_samples) == (win, hop)
    got = _port(p, "mfcc", golden["audio_default"][None])[0]
    np.testing.assert_allclose(got, golden["mfcc_alt"], rtol=GOLD_RTOL,
                               atol=GOLD_ATOL)


def test_add_deltas_first_frame_zero():
    rng = np.random.default_rng(3)
    f = torch.tensor(rng.standard_normal((2, 5, 3)).astype(np.float32))
    out = add_deltas(f)
    assert out.shape == (2, 5, 6)
    assert torch.all(out[:, 0, 3:] == 0)
    torch.testing.assert_close(out[:, 1:, 3:], f[:, 1:] - f[:, :-1])


def test_short_audio_raises():
    with pytest.raises(ValueError, match="n_features"):
        Frontend(ListenerParams(), device="cpu")(torch.zeros(2, 8000))


def test_pad_audio_left_pads_and_trims():
    fe = Frontend(ListenerParams(), device="cpu")
    padded = fe.pad_audio(torch.ones(2, 7000))
    assert padded.shape == (2, 16000) and torch.all(padded[:, :9000] == 0)
    assert fe.pad_audio(torch.ones(2, 20000)).shape == (2, 16000)


def test_frontend_snapshots_params():
    p = ListenerParams()
    fe = Frontend(p, device="cpu")
    assert fe.params == p and fe.params is not p


def test_wrapper_on_cpu_is_the_plain_chain(audio_batch):
    p = ListenerParams(use_delta=True)
    audio = torch.tensor(audio_batch)
    for out_dtype in (torch.float32, torch.bfloat16):
        fe = MfccFrontend(p, "mfcc", "cpu", out_dtype=out_dtype)
        got = fe(audio, 0.9)
        assert got.dtype == out_dtype
        want = Frontend(p, device="cpu")(audio, 0.9).to(out_dtype)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_constants_row_major():
    """The kernel indexes its constants as row-major arrays; a transposed
    view handed over by data_ptr() would silently give wrong features."""
    from tpu_speech_commands.frontend import dsp as jax_dsp

    p = ListenerParams()
    c = KernelConstants(p, "mfcc", "cpu")
    for t in (c.twiddle, c.filt_t, c.dct_t):
        assert t.is_contiguous() and t.dtype == torch.float32
    np.testing.assert_array_equal(c.dct_t.numpy(), jax_dsp.dct_t_matrix(20))
    np.testing.assert_array_equal(c.filt_t.numpy(),
                                  jax_dsp.mel_matrix(16000, 20, 513).T)
    k = np.arange(512)
    np.testing.assert_allclose(
        c.twiddle.numpy(),
        np.stack([np.cos(2 * np.pi * k / 1024), -np.sin(2 * np.pi * k / 1024)],
                 -1), atol=1e-7)


@pytest.mark.parametrize("kw,match", [
    ({"n_fft": 500, "window_t": 0.03}, "power of two"),
    ({"n_fft": 768, "window_t": 0.048}, "power of two"),
    ({"n_mfcc": 24}, "n_mfcc <= n_filt"),
])
def test_kernel_refuses_configs_it_cannot_take(kw, match):
    """The FFT kernel's refusals; its wrapper raises on them before it looks
    at the device, so no config reaches it silently.  (`MfccFrontend` sends
    the first two down other routes: tests/test_torch_routes.py.)"""
    p = ListenerParams(**kw)
    assert match in kernel_config_error(p)
    with pytest.raises(ValueError, match=match):
        frontend_kernel.mfcc_frontend_cuda(
            torch.zeros(1, 16000), torch.ones(1),
            KernelConstants(p, "mfcc", "cpu"), p)
    assert kernel_config_error(ListenerParams()) is None
    # a window longer than n_fft: the kernel reads a frame's first n_fft
    assert kernel_config_error(ListenerParams(n_fft=512)) is None


def test_raw_wrapper_refuses_cpu_tensors():
    p = ListenerParams()
    with pytest.raises(ValueError, match="audio on cpu"):
        frontend_kernel.mfcc_frontend_cuda(
            torch.zeros(1, 16000), torch.ones(1),
            KernelConstants(p, "mfcc", "cpu"), p)
