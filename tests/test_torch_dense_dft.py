"""The port's f32 dense-DFT frontends (`ops/dense_dft_kernel.py`) against the
JAX package's `tools/dev/pallas_experiments.py::make_combined_kernel` and
`make_reshape_kernel`, run in TPU interpret mode on the CPU.

`tools/dev` is not a package: the script is loaded by its file path.  Audio
is made from a numpy seed.  Configs are set through both packages' own `pr`
(tests/conftest.py restores the JAX one, the fixture below the port's).
Tolerances:
- plain vs the JAX kernels, and vs the port's `Frontend`: atol 1e-5 /
  rtol 1e-5, f32 sums in another order (1.4e-6 measured at the default
  config);
- the numpy emulation of the CUDA kernels' layout (column pairs, tiles, hop
  blocks, the Nyquist slot), float64, vs the f32 plain version: atol 1e-4 /
  rtol 1e-4, f32 rounding of the plain version only.

The CUDA kernels against the plain versions on the card: test_torch_gpu.py.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_speech_commands.params import pr as jax_pr
from tpu_speech_commands_torch.dev import pallas_experiments as port_pe
from tpu_speech_commands_torch.frontend.dsp import Frontend
from tpu_speech_commands_torch.frontend.filterbanks import (LOG_EPS,
                                                           filterbank_matrix)
from tpu_speech_commands_torch.ops import dense_dft_kernel as D
from tpu_speech_commands_torch.ops.frontend_kernel import pack_filterbank
from tpu_speech_commands_torch.params import ListenerParams, pr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = RTOL = 1e-5
EMU_TOL = 1e-4

DEFAULT = {}
WINDOW_50 = {"window_t": 0.05}                      # W 800 < n_fft
HALVES_400 = {"window_t": 0.05, "hop_t": 0.025}     # W = 2 hop = 800
COMBINED_CONFIGS = {"default": DEFAULT, "window_t=0.05": WINDOW_50,
                    "window_t=0.05,hop_t=0.025": HALVES_400}
HALVES_CONFIGS = {"default": DEFAULT, "window_t=0.05,hop_t=0.025": HALVES_400}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_dev_{name}", os.path.join(REPO, "tools", "dev", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_pe():
    return _load_script("pallas_experiments")


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """The port's `pr` is its own; tests/conftest.py restores only the JAX
    package's."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _set_both(kw):
    jax_pr.override(kw)
    pr.override(kw)
    return ListenerParams(**kw)


def _audio(batch, seed=0, n_samples=16000):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (batch, n_samples)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(COMBINED_CONFIGS))
def test_combined_plain_matches_jax_kernel(jax_pe, name):
    p = _set_both(COMBINED_CONFIGS[name])
    audio = _audio(32, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_pe.make_combined_kernel(16)(jnp.asarray(audio)))
    got = port_pe.make_combined_kernel("cpu")(torch.tensor(audio)).numpy()
    assert got.shape == want.shape == (32, D.n_frames_of(p, 16000), p.n_mfcc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(HALVES_CONFIGS))
def test_halves_plain_matches_jax_reshape_kernel(jax_pe, name):
    p = _set_both(HALVES_CONFIGS[name])
    audio = _audio(32, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_pe.make_reshape_kernel(16)(jnp.asarray(audio)))
    got = port_pe.make_reshape_kernel("cpu")(torch.tensor(audio)).numpy()
    assert got.shape == want.shape == (32, D.n_frames_of(p, 16000), p.n_mfcc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(COMBINED_CONFIGS))
def test_plain_versions_match_the_frontend(name):
    """At these configs every frame is a kept frame, so both equal the port's
    mfcc Frontend; halves wherever window == 2 hop."""
    p = ListenerParams(**COMBINED_CONFIGS[name])
    assert D.n_frames_of(p, p.max_samples) == p.n_features
    audio = torch.tensor(_audio(5, seed=3))
    want = Frontend(p, "mfcc", "cpu")(audio)
    consts = D.DenseDftConstants(p, "cpu")
    torch.testing.assert_close(D.dense_dft_combined_plain(audio, consts), want,
                               rtol=RTOL, atol=ATOL)
    if consts.halves is not None:
        torch.testing.assert_close(D.dense_dft_halves_plain(audio, consts),
                                   want, rtol=RTOL, atol=ATOL)


def test_dispatchers_on_cpu_are_the_plain_versions():
    p = ListenerParams()
    consts = D.DenseDftConstants(p, "cpu")
    audio = torch.tensor(_audio(3, seed=4))
    for dispatch, plain in ((D.dense_dft_combined, D.dense_dft_combined_plain),
                            (D.dense_dft_halves, D.dense_dft_halves_plain)):
        torch.testing.assert_close(dispatch(audio, consts), plain(audio, consts),
                                   rtol=0, atol=0)
    torch.testing.assert_close(port_pe.make_combined_kernel("cpu")(audio),
                               D.dense_dft_combined_plain(audio, consts),
                               rtol=0, atol=0)


def test_refusals_raise_value_error_on_every_device():
    odd = ListenerParams(window_t=0.05)  # window 800 != 2 x hop 512
    consts = D.DenseDftConstants(odd, "cpu")
    assert consts.halves is None
    audio = torch.zeros(2, 16000)
    with pytest.raises(ValueError, match="window == 2 hop"):
        D.dense_dft_halves_plain(audio, consts)
    with pytest.raises(ValueError, match="window == 2 hop"):
        D.dense_dft_halves_cuda(audio, consts)
    with pytest.raises(ValueError, match="mfcc only"):
        D.DenseDftConstants(ListenerParams(), "cpu", feature_type="bark")
    pr.override({"window_t": 0.05})
    with pytest.raises(ValueError, match="window == 2 hop"):
        port_pe.make_reshape_kernel("cpu")
    with pytest.raises(ValueError, match="shorter than one window"):
        D.dense_dft_combined_plain(torch.zeros(2, 100), consts)
    with pytest.raises(TypeError):
        D.dense_dft_combined_plain(audio.double(), consts)


def test_raw_wrappers_refuse_cpu_tensors():
    consts = D.DenseDftConstants(ListenerParams(), "cpu")
    for launch in (D.dense_dft_combined_cuda, D.dense_dft_halves_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(torch.zeros(2, 16000), consts)


def test_column_pairs_hold_every_bin():
    """(cos 0, cos n_fft/2), then (cos p, sin p): the Nyquist and bin-0 sin
    columns, which the pairs drop, are zero."""
    for n_fft, window_t in ((1024, 0.064), (512, 0.025), (999, 0.05)):
        p = ListenerParams(n_fft=n_fft, window_t=window_t)
        cs = D.DenseDftConstants(p, "cpu").cos_sin.numpy()
        bins = p.n_fft_bins
        pairs = D.column_pairs(p, p.window_samples)
        n_pairs = (n_fft + 1) // 2
        assert pairs.shape == (p.window_samples, 2 * n_pairs)
        np.testing.assert_array_equal(pairs[:, 0::2], cs[:, :n_pairs])
        np.testing.assert_array_equal(pairs[:, 3::2],
                                      cs[:, bins + 1:bins + n_pairs])
        assert np.abs(cs[:, bins]).max() == 0.0  # sin of bin 0
        if n_fft % 2 == 0:
            np.testing.assert_array_equal(pairs[:, 1], cs[:, n_pairs])
            assert np.abs(cs[:, -1]).max() < 1e-4  # sin of the Nyquist bin
        else:
            assert not pairs[:, 1].any()


def _emulate_kernel(audio: np.ndarray, p: ListenerParams, halves: bool):
    """csrc/dense_dft_frontend.cu's algorithm in float64 numpy, on the host
    constants the wrapper hands it: the grid of (window group, frame tile)
    blocks, each row's audio offset, the chunked column-pair matrix, the
    thread-to-pair mapping of the epilogue, the halves' block-(t + 1)
    combination and the Nyquist slot."""
    consts = D.DenseDftConstants(p, "cpu")
    mat = (consts.halves if halves else consts.combined).numpy().astype(np.float64)
    batch, n_samples = audio.shape
    hop, n_fft = p.hop_samples, p.n_fft
    n_frames = D.n_frames_of(p, n_samples)
    tile = D.tiling(n_frames, halves)
    R = tile.rows_per_win
    per_tile = R - 1 if halves else R
    row_limit = n_frames + 1 if halves else n_frames
    k_valid = hop if halves else min(p.window_samples, n_fft)
    k_pad, width = mat.shape
    assert k_pad % D.BK == 0 and width % D.BN == 0 and tile.wpb * R <= D.BM
    n_chunks = width // D.BN
    n_pairs = (n_fft + 1) // 2
    ppc = D.BN // 4 if halves else D.BN // 2
    packed, ranges = pack_filterbank(filterbank_matrix(p, "mfcc").T)
    dct_t = consts.dct_t.numpy().astype(np.float64)
    out = np.full((batch, n_frames, p.n_mfcc), np.nan)
    for bx in range(-(-batch // tile.wpb)):
        for by in range(tile.n_tiles):
            b0, f0 = bx * tile.wpb, by * per_tile
            nb = min(tile.wpb, batch - b0)
            a = np.zeros((D.BM, k_pad))
            frame = np.zeros(D.BM, bool)
            for r in range(D.BM):
                lw, i = divmod(r, R)
                if lw < nb and f0 + i < row_limit:
                    start = (f0 + i) * hop
                    a[r, :k_valid] = audio[b0 + lw, start:start + k_valid]
                frame[r] = lw < nb and i < per_tile and f0 + i < n_frames
            acc_all = a @ mat
            power = np.zeros((D.BM, n_pairs + 1))
            for c in range(n_chunks):
                acc = acc_all[:, c * D.BN:(c + 1) * D.BN]
                for tx in range(16):
                    cols = [4 * tx + j for j in range(4)] + \
                           [D.BN // 2 + 4 * tx + j for j in range(4)]
                    if halves:
                        nxt = np.roll(acc, -1, axis=0)
                        quads = [(2 * tx + q,
                                  acc[:, cols[2 * q]] + nxt[:, cols[4 + 2 * q]],
                                  acc[:, cols[2 * q + 1]] + nxt[:, cols[5 + 2 * q]])
                                 for q in range(2)]
                    else:
                        quads = [((0 if q < 2 else D.BN // 4 - 2) + 2 * tx + q,
                                  acc[:, cols[2 * q]], acc[:, cols[2 * q + 1]])
                                 for q in range(4)]
                    for pl, re, im in quads:
                        pair = c * ppc + pl
                        if pair >= n_pairs:
                            continue
                        if pair == 0:
                            power[:, 0] = re * re / n_fft
                            if n_fft % 2 == 0:
                                power[:, n_pairs] = im * im / n_fft
                        else:
                            power[:, pair] = (re * re + im * im) / n_fft
            mel = np.zeros((D.BM, p.n_filt))
            for m, (lo, hi, off) in enumerate(ranges):
                mel[:, m] = power[:, lo:hi] @ packed[off:off + hi - lo]
            coeffs = np.log(np.clip(mel, LOG_EPS, None)) @ dct_t
            coeffs[:, 0] = np.log(np.clip(power.sum(1), LOG_EPS, None))
            for r in np.flatnonzero(frame):
                lw, i = divmod(r, R)
                out[b0 + lw, f0 + i] = coeffs[r, :p.n_mfcc]
    return out


EMULATED = {  # name: (config, batch)
    "default": ({}, 9),
    "window_t=0.05,hop_t=0.025": ({"window_t": 0.05, "hop_t": 0.025}, 5),
    "n_fft=512,hop=160 (98/99 frames)": (
        {"window_t": 0.025, "hop_t": 0.01, "n_fft": 512, "n_filt": 26,
         "n_mfcc": 13}, 2),
    "window=2hop=320 (99 frames, 100 blocks)": (
        {"window_t": 0.02, "hop_t": 0.01, "n_fft": 512, "n_filt": 26,
         "n_mfcc": 13}, 2),
    "hop=80 (199 frames, two tiles a window)": (
        {"window_t": 0.01, "hop_t": 0.005, "n_fft": 256}, 2),
    "odd n_fft=999": ({"window_t": 0.05, "n_fft": 999}, 3),
}


# halves takes window == 2 hop only (its refusal is tested above)
EMULATED_CASES = [(name, False) for name in sorted(EMULATED)] + [
    (name, True) for name in sorted(EMULATED)
    if ListenerParams(**EMULATED[name][0]).window_samples
    == 2 * ListenerParams(**EMULATED[name][0]).hop_samples]


@pytest.mark.parametrize("name,halves", EMULATED_CASES)
def test_kernel_layout_emulated_gives_the_plain_features(name, halves):
    kw, batch = EMULATED[name]
    p = ListenerParams(**kw)
    audio = _audio(batch, seed=5)
    consts = D.DenseDftConstants(p, "cpu")
    plain = D.dense_dft_halves_plain if halves else D.dense_dft_combined_plain
    want = plain(torch.tensor(audio), consts).numpy()
    got = _emulate_kernel(audio, p, halves)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=EMU_TOL, atol=EMU_TOL)


def test_r4_float64_reference_matches_numpy_ref():
    """dev/r4_mxu_stage1.py's float64 reference, which may not import the JAX
    package, against the JAX package's own float64 oracle
    (frontend/numpy_ref.py::vectorize_raw), which r4 used."""
    from tpu_speech_commands.frontend import numpy_ref
    from tpu_speech_commands_torch.dev.r4_mxu_stage1 import oracle_mfcc

    p = ListenerParams()
    audio = _audio(3, seed=6)
    want = np.stack([numpy_ref.vectorize_raw(row.astype(np.float64), jax_pr)
                     for row in audio])[:, -p.n_features:, :]
    np.testing.assert_allclose(oracle_mfcc(audio, p), want, rtol=1e-9,
                               atol=1e-9)
