"""The port's fast_math frontend (plain version of `csrc/dft_frontend.cu`)
against the JAX package's `make_fused_frontend(fast_math=True)` in
interpret mode, and the kernel's host-side layout and constants.

The same numpy audio, made from a seed, goes through both packages.
Tolerances:
- vs JAX's dense fast_math (dft_mode='dense'): rtol 1e-5 / atol 1e-5.  Both
  round the decoded, gained frames and the cos/sin matrices to bf16 and
  accumulate the exact products in f32, so only the summation order
  differs (measured <= 2.1e-6);
- vs JAX's default fast_math (the Cooley-Tukey split, whose bf16 stage-1
  sums round differently) and vs the exact f32 frontend: atol 0.05, the
  bound tests/test_pallas_frontend.py holds JAX fast_math to.

The CUDA kernel against the plain version on the card: test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.ops import make_fused_frontend
from tpu_speech_commands_torch.frontend import Frontend, frame_signal
from tpu_speech_commands_torch.frontend.dsp import decode_audio, safe_log
from tpu_speech_commands_torch.frontend.filterbanks import (
    dct_t_matrix,
    dft_matrices,
    filterbank_matrix,
)
from tpu_speech_commands_torch.ops import frontend_kernel
from tpu_speech_commands_torch.ops.frontend_kernel import (
    DFT_BM,
    DftConstants,
    MfccFrontend,
    dft_config_error,
    dft_layout,
    pack_filterbank,
)
from tpu_speech_commands_torch.params import ListenerParams

RTOL, ATOL = 1e-5, 1e-5
LOOSE_ATOL = 0.05

# name -> (ListenerParams kwargs, feature_type)
CONFIGS = {
    "mfcc": ({}, "mfcc"),
    "bark": ({}, "bark"),
    "use_delta": ({"use_delta": True}, "mfcc"),
    "window_t=0.05": ({"window_t": 0.05}, "mfcc"),  # zero-padded DFT
    "odd_hop": ({"hop_t": 0.03}, "mfcc"),  # 32 frames framed, 31 kept
    "alt_512": ({"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                 "n_filt": 26, "n_mfcc": 13}, "mfcc"),
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


def _port(p, feature_type, audio, gain=None, fast_math=True):
    return Frontend(p, feature_type, "cpu", fast_math=fast_math)(
        torch.tensor(audio), gain).numpy()


def _jax_dense(p, feature_type, audio, gain=None):
    fused = make_fused_frontend(p, feature_type=feature_type, batch_tile=4,
                                interpret=True, fast_math=True,
                                dft_mode="dense", emit_deltas=p.use_delta)
    return np.asarray(fused(jnp.asarray(audio), gain))


@pytest.mark.parametrize("name", ["mfcc", "bark", "use_delta",
                                  "window_t=0.05"])
def test_plain_matches_jax_dense_fast_math(audio_batch, name):
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    got = _port(p, feature_type, audio_batch)
    want = _jax_dense(p, feature_type, audio_batch)
    assert got.shape == want.shape == (4, p.n_features, p.feature_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_matches_jax_dense_fast_math_int16_gain(audio_batch):
    """int16 PCM with a gain: decode, then gain, then the bf16 rounding."""
    pcm = np.clip(np.round(audio_batch * 32768.0), -32768,
                  32767).astype(np.int16)
    p = ListenerParams()
    got = _port(p, "mfcc", pcm, gain=0.7)
    want = _jax_dense(p, "mfcc", pcm, gain=0.7)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mfcc", "bark", "use_delta"])
def test_plain_near_jax_ct_fast_math_and_exact(audio_batch, name):
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    got = _port(p, feature_type, audio_batch)
    ct = make_fused_frontend(p, feature_type=feature_type, batch_tile=4,
                             interpret=True, fast_math=True,
                             emit_deltas=p.use_delta)
    want_ct = np.asarray(ct(jnp.asarray(audio_batch)))
    exact = _port(p, feature_type, audio_batch, fast_math=False)
    assert np.abs(got - want_ct).max() < LOOSE_ATOL
    assert np.abs(got - exact).max() < LOOSE_ATOL
    assert np.abs(got - exact).max() > 0  # the bf16 rounding did happen


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_mfcc_frontend_fast_math_on_cpu_is_the_plain_chain(audio_batch,
                                                           out_dtype):
    p = ListenerParams()
    fe = MfccFrontend(p, "mfcc", "cpu", out_dtype=out_dtype, fast_math=True)
    audio = torch.tensor(audio_batch)
    want = Frontend(p, "mfcc", "cpu", fast_math=True)(audio, 0.9).to(out_dtype)
    torch.testing.assert_close(fe(audio, 0.9), want, rtol=0, atol=0)
    # a config the kernel cannot take still runs its plain chain on the CPU
    odd = ListenerParams(hop_t=0.0101)
    assert dft_config_error(odd) is not None
    got = MfccFrontend(odd, "mfcc", "cpu", fast_math=True)(audio)
    assert got.shape == (4, odd.n_features, odd.feature_size)


def test_fast_math_false_is_unchanged_bit_for_bit(audio_batch):
    """The f32 chain, written out: fast_math=False must still be exactly
    it."""
    p = ListenerParams()
    audio = torch.tensor(audio_batch)
    cos, sin = (torch.tensor(m) for m in dft_matrices(p.window_samples, p.n_fft))
    frames = frame_signal(decode_audio(audio, 0.8), p.window_samples,
                          p.hop_samples)[..., -p.n_features:, :]
    re, im = torch.matmul(frames, cos), torch.matmul(frames, sin)
    power = (re * re + im * im) / p.n_fft
    mels = safe_log(torch.matmul(power, torch.tensor(
        filterbank_matrix(p, "mfcc"))))
    coeffs = torch.matmul(mels, torch.tensor(dct_t_matrix(p.n_filt)))
    energy = safe_log(power.sum(dim=-1, keepdim=True))
    want = torch.cat([energy, coeffs[..., 1:p.n_mfcc]], dim=-1)
    got = MfccFrontend(p, "mfcc", "cpu")(audio, 0.8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    plain = Frontend(p, "mfcc", "cpu", fast_math=False)
    torch.testing.assert_close(plain(audio, 0.8), want, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dft_constants_row_major_bf16_padded(name):
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    consts = DftConstants(p, feature_type, "cpu")
    lay = consts.layout
    assert consts.dft.dtype == torch.bfloat16 and consts.dft.is_contiguous()
    assert tuple(consts.dft.shape) == (lay.n_pad, lay.k_pad)
    assert lay.k_pad % 64 == 0 and lay.n_pad % 16 == 0
    assert lay.n_pad >= 2 * p.n_fft_bins and lay.k_pad >= lay.k_eff
    assert consts.dft.stride() == (lay.k_pad, 1)
    assert consts.filt_packed.dtype == torch.float32
    assert consts.filt_packed.is_contiguous() and consts.filt_packed.ndim == 1
    assert consts.filt_range.dtype == torch.int32
    assert consts.filt_range.is_contiguous()
    assert tuple(consts.filt_range.shape) == (p.n_filt, 3)
    assert consts.dct_t.is_contiguous()
    assert tuple(consts.dct_t.shape) == (p.n_filt, p.n_filt)
    # rows 2k / 2k+1 are bin k's cos / sin, rounded to bf16; the rest zero
    cos, sin = dft_matrices(p.window_samples, p.n_fft)
    dft = consts.dft.float()
    k = lay.k_eff
    bf = torch.bfloat16
    torch.testing.assert_close(dft[0:2 * lay.n_bins:2, :k],
                               torch.tensor(cos[:k].T).to(bf).float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(dft[1:2 * lay.n_bins:2, :k],
                               torch.tensor(sin[:k].T).to(bf).float(),
                               rtol=0, atol=0)
    assert not dft[2 * lay.n_bins:].any() and not dft[:, k:].any()
    # the packed filterbank unpacks to the filterbank, bit for bit
    filt_t = np.zeros((p.n_filt, p.n_fft_bins), np.float32)
    packed = consts.filt_packed.numpy()
    for m, (lo, hi, off) in enumerate(consts.filt_range.tolist()):
        filt_t[m, lo:hi] = packed[off:off + hi - lo]
    np.testing.assert_array_equal(filt_t, filterbank_matrix(p, feature_type).T)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_layout_emulated_gives_the_plain_power(audio_batch, name):
    """Stage the audio as the kernel does (hop segments seg_pitch apart),
    read each frame back through the k-offset table, multiply by the bf16
    DFT constant: the power spectrum is the plain fast_math one.  Also: 8
    consecutive frames start in 8 distinct 16-byte bank groups, and no
    8-element read crosses into a segment gap."""
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    lay = dft_layout(p, feature_type)
    consts = DftConstants(p, feature_type, "cpu")
    hop, n_feat = p.hop_samples, p.n_features
    n_samples = audio_batch.shape[1]
    first = 1 + (n_samples - p.window_samples) // hop - n_feat
    x = torch.tensor(audio_batch).to(torch.bfloat16).float().numpy()
    koff = np.array([k + (k // hop) * (lay.seg_pitch - hop)
                     for k in range(0, lay.k_pad, 8)])
    assert all(k % lay.seg_pitch + 8 <= hop for k in koff)
    starts = np.arange(8) * lay.seg_pitch * 2 // 16 % 8
    assert len(set(starts)) == 8
    smem = np.full((len(x), lay.win_pitch), np.nan, np.float32)
    for seg in range(lay.n_seg):
        g = (first + seg) * hop + np.arange(hop)
        vals = np.where(g < n_samples, x[:, np.minimum(g, n_samples - 1)], 0.0)
        smem[:, seg * lay.seg_pitch:seg * lay.seg_pitch + hop] = vals
    idx = (np.arange(n_feat)[:, None] * lay.seg_pitch
           + (koff[:, None] + np.arange(8)).reshape(-1)[None, :])
    frames = smem[:, idx]  # (B, n_feat, k_pad)
    assert np.isfinite(frames).all()  # never read a gap
    reim = torch.tensor(frames) @ consts.dft.float().T
    re, im = reim[..., 0:2 * lay.n_bins:2], reim[..., 1:2 * lay.n_bins:2]
    got = (re * re + im * im) / p.n_fft
    plain = Frontend(p, feature_type, "cpu", fast_math=True)
    want = plain.power_from_frames(
        frame_signal(torch.tensor(audio_batch), p.window_samples,
                     hop)[..., -n_feat:, :])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_packed_filterbank_ranges_cover_every_nonzero():
    for feature_type in ("mfcc", "bark"):
        filt_t = filterbank_matrix(ListenerParams(), feature_type).T
        packed, ranges = pack_filterbank(filt_t)
        assert len(packed) == sum(hi - lo for lo, hi, _ in ranges)
        assert len(packed) < filt_t.size // 4  # sparse: what makes it fit
        for row, (lo, hi, off) in zip(filt_t, ranges):
            assert not row[:lo].any() and not row[hi:].any()
            assert lo == hi or (row[lo] != 0 and row[hi - 1] != 0)
    packed, ranges = pack_filterbank(np.zeros((2, 5), np.float32))
    assert len(packed) == 0 and ranges.tolist() == [[0, 0, 0], [0, 0, 0]]


def test_dft_config_errors():
    assert dft_config_error(ListenerParams()) is None
    assert "multiple of 8" in dft_config_error(ListenerParams(hop_t=0.0101))
    assert "n_mfcc <= n_filt" in dft_config_error(
        ListenerParams(n_filt=13, n_mfcc=20))
    many = ListenerParams(buffer_t=2.0, hop_t=0.01)
    assert many.n_features > DFT_BM
    assert "frames a window" in dft_config_error(many)
    # 8 s windows: one window's audio does not fit in shared memory
    long = ListenerParams(buffer_t=8.0, window_t=0.128, hop_t=0.064,
                          n_fft=2048)
    assert long.n_features <= DFT_BM
    assert "shared memory" in dft_config_error(long)
    assert dft_layout(ListenerParams()).wpb == 4


def test_raw_wrapper_refuses_cpu_tensors():
    p = ListenerParams()
    consts = DftConstants(p, "mfcc", "cpu")
    with pytest.raises(ValueError, match="kernel constants"):
        frontend_kernel.dft_frontend_bf16_cuda(
            torch.zeros(2, 16000), torch.ones(1), consts, p)
