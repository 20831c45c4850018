"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where torch.cuda.is_available() is
False: a CUDA kernel has no CPU mode.  The file imports no jax, so it runs on
a machine with a GPU and no jax (tests/conftest.py imports jax; skip it):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances, each with its reason:
- features f32: atol 2e-3 / rtol 1e-3: the kernel's radix-2 FFT and the plain
  dense-DFT matmul sum in another order, magnified by the log (the bound
  tests/test_frontend_jax.py holds JAX f32 features to);
- features bf16: the same plus one bf16 rounding step (2^-7 relative);
- GRU logits f32: atol 1e-4 / rtol 1e-5 (same math, other summation order);
- GRU logits and scores bf16: atol 5e-2 (bf16 rounding can flip at a
  boundary and grow over 30 steps; the bound tests/test_serving.py allows);
- scores f32, card vs CPU: atol 1e-3 (the feature bound through the GRU).
"""
import glob
import os
import wave

import numpy as np
import pytest
import torch

from tpu_speech_commands_torch.models.rnn import SimpleGRU
from tpu_speech_commands_torch.ops import frontend_kernel, rnn_kernel
from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
from tpu_speech_commands_torch.ops.rnn_kernel import GRUClassifier
from tpu_speech_commands_torch.params import ListenerParams
from tpu_speech_commands_torch.serving import make_batch_scorer

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRU_CKPT = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")

CONFIGS = {
    "mfcc": ({}, "mfcc"),
    "bark": ({}, "bark"),
    "use_delta": ({"use_delta": True}, "mfcc"),
    "window_t=0.05": ({"window_t": 0.05}, "mfcc"),
    "odd_hop": ({"hop_t": 0.03}, "mfcc"),
    "alt_512": ({"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                 "n_filt": 26, "n_mfcc": 13}, "mfcc"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _clips():
    audio, labels = [], []
    for path in sorted(glob.glob(os.path.join(REPO, "example", "*.wav"))):
        with wave.open(path, "rb") as wf:
            pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        pcm = pcm[-16000:]
        audio.append(np.pad(pcm, (16000 - len(pcm), 0)))
        labels.append(os.path.basename(path).split("_")[0])
    return np.stack(audio), labels


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_frontend_kernel_matches_plain(cuda_device, name, audio_dtype,
                                       out_dtype):
    """B = 13: one block a window, so no tile multiple matters."""
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    clips, _ = _clips()
    rows = clips[np.arange(13) % 8].astype(np.float32) / 32768.0
    audio = rows * np.linspace(0.3, 1.5, 13, dtype=np.float32)[:, None]
    if audio_dtype == "int16":
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    audio = torch.tensor(audio, device=cuda_device)
    fe = MfccFrontend(p, feature_type, cuda_device, out_dtype=out_dtype)
    before = frontend_kernel.mfcc_frontend_cuda.launches
    got = fe(audio, 0.8)
    torch.cuda.synchronize()
    assert frontend_kernel.mfcc_frontend_cuda.launches == before + 1
    assert got.shape == (13, p.n_features, p.feature_size)
    assert got.dtype == out_dtype
    want = fe.plain(audio, 0.8).to(out_dtype)
    rtol = 1e-3 if out_dtype == torch.float32 else 1e-3 + 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-3)


def test_frontend_kernel_rejects_what_it_cannot_take(cuda_device):
    fe = MfccFrontend(ListenerParams(), "mfcc", cuda_device)
    with pytest.raises(TypeError):
        fe(torch.zeros(2, 16000, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        fe(torch.zeros(2, 32000, device=cuda_device)[:, ::2])  # strided
    with pytest.raises(ValueError):
        fe(torch.zeros(2, 8000, device=cuda_device))  # too short
    assert fe(torch.zeros(0, 16000, device=cuda_device)).shape == (0, 30, 20)


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_gru_kernel_matches_plain(cuda_device, num_layers, compute_dtype):
    """B = 37: a ragged last tile.  Weights from a numpy seed."""
    model = SimpleGRU(5, 20, 48, num_layers)
    rng = np.random.default_rng(num_layers)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.tensor(0.1 * rng.standard_normal(tuple(prm.shape)),
                                   dtype=torch.float32))
    model = model.to(cuda_device).eval()
    x = torch.tensor(rng.standard_normal((37, 30, 20)), dtype=torch.float32,
                     device=cuda_device).to(compute_dtype)
    before = rnn_kernel.gru_layer_cuda.launches
    got = GRUClassifier(model, compute_dtype)(x)
    torch.cuda.synchronize()
    assert rnn_kernel.gru_layer_cuda.launches == before + num_layers
    with torch.no_grad():
        want = model(x.float(), compute_dtype)
    atol = 1e-4 if compute_dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_scorer_runs_both_kernels(cuda_device, compute_dtype):
    audio, labels = _clips()
    scorer = make_batch_scorer(GRU_CKPT, cuda_device, compute_dtype)
    assert scorer.paths["frontend"].startswith("cuda-mfcc")
    assert scorer.paths["classifier"] == "cuda-gru"
    frontend_kernel.mfcc_frontend_cuda.launches = 0
    rnn_kernel.gru_layer_cuda.launches = 0
    got = scorer(torch.tensor(audio, device=cuda_device)).cpu()
    assert frontend_kernel.mfcc_frontend_cuda.launches == 1
    assert rnn_kernel.gru_layer_cuda.launches == 1
    assert [scorer.classes[i] for i in got.argmax(-1)] == labels
    want = make_batch_scorer(GRU_CKPT, "cpu", compute_dtype)(audio)
    atol = 1e-3 if compute_dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
