"""The port's frontend constant matrices equal the JAX package's exactly.

Both are built in float64 numpy and stored as float32, from the same
formulas (mel high edge at sample_rate, bark's default-constant bin
mapping), so the comparison is bit-for-bit: tolerance 0.
"""
import numpy as np
import pytest

from tpu_speech_commands.frontend import dsp as jax_dsp
from tpu_speech_commands.frontend import numpy_ref
from tpu_speech_commands_torch.frontend import filterbanks as fb

# (sample_rate, n_filt, n_fft): the default, the golden fixture's alternate
# config, a small transform, and a non-power-of-two FFT
CONFIGS = [(16000, 20, 1024), (16000, 26, 512), (8000, 13, 256),
           (16000, 24, 500)]


def test_log_eps_is_float64_eps():
    assert fb.LOG_EPS == numpy_ref.LOG_EPS == jax_dsp.LOG_EPS


@pytest.mark.parametrize("sample_rate,n_filt,n_fft", CONFIGS)
def test_mel_matrix_equal(sample_rate, n_filt, n_fft):
    fft_len = n_fft // 2 + 1
    np.testing.assert_array_equal(
        fb.mel_filterbanks(sample_rate, n_filt, fft_len),
        numpy_ref.mel_filterbanks(sample_rate, n_filt, fft_len))
    got = fb.mel_matrix(sample_rate, n_filt, fft_len)
    assert got.dtype == np.float32 and got.shape == (fft_len, n_filt)
    np.testing.assert_array_equal(
        got, jax_dsp.mel_matrix(sample_rate, n_filt, fft_len))


@pytest.mark.parametrize("sample_rate,n_filt,n_fft", CONFIGS)
def test_bark_matrix_equal(sample_rate, n_filt, n_fft):
    np.testing.assert_array_equal(
        fb.bark_filterbanks(n_filt, n_fft, sample_rate),
        numpy_ref.bark_filterbanks(n_filt, n_fft, sample_rate))
    got = fb.bark_matrix(sample_rate, n_filt, n_fft)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jax_dsp.bark_matrix(sample_rate, n_filt, n_fft))


@pytest.mark.parametrize("n", [13, 20, 26])
def test_dct_matrices_equal(n):
    np.testing.assert_array_equal(fb.dct_matrix(n), numpy_ref.dct_matrix(n))
    np.testing.assert_array_equal(fb.dct_t_matrix(n), jax_dsp.dct_t_matrix(n))


@pytest.mark.parametrize("window,n_fft", [(1024, 1024), (800, 1024),
                                          (400, 512), (600, 512)])
def test_dft_matrices_equal(window, n_fft):
    """Zero-padded (window < n_fft) and truncated (window > n_fft) frames."""
    for got, want in zip(fb.dft_matrices(window, n_fft),
                         jax_dsp.dft_matrices(window, n_fft)):
        assert got.shape == (window, n_fft // 2 + 1)
        np.testing.assert_array_equal(got, want)


def test_filterbank_matrix_picks_by_feature_type():
    from tpu_speech_commands_torch.params import ListenerParams

    p = ListenerParams()
    np.testing.assert_array_equal(fb.filterbank_matrix(p, "mfcc"),
                                  jax_dsp.mel_matrix(16000, 20, 513))
    np.testing.assert_array_equal(fb.filterbank_matrix(p, "bark"),
                                  jax_dsp.bark_matrix(16000, 20, 1024))
    with pytest.raises(ValueError, match="feature_type"):
        fb.filterbank_matrix(p, "plp")
