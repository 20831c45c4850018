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
- GRU logits f32 (the tile and the SIMT kernel): atol 1e-4 / rtol 1e-5
  (same math, other summation order);
- GRU logits and scores bf16: atol 5e-2 (bf16 rounding can flip at a
  boundary and grow over 30 steps; the bound tests/test_serving.py allows);
- scores f32, card vs CPU: atol 1e-3 (the feature bound through the GRU);
- CNN logits f32: atol 1e-4 / rtol 1e-5 (another summation order over
  K <= 576); bf16: atol 5e-2 (a bf16 rounding of an activation can flip);
- CNN block-1 activations f32: atol 1e-5 / rtol 1e-5; bf16: atol 5e-2;
- fast_math features: the bounds of the f32 features above (the kernel's
  bf16 frames and DFT matrix are the plain version's values bit for bit;
  only the f32 sums run in another order);
- LSTM logits f32 (the tile and the SIMT kernel): atol 1e-4 / rtol 1e-5;
  bf16: atol 5e-2 (as the GRU);
- dense-DFT features: the bounds of the f32 features above (the same f32
  math in another summation order, magnified by the log);
- load-floor row sums: per row |err| <= 2e-6 * sum |gain * x| (16,000 f32
  terms summed in another order; the sums reach the hundreds);
- CT split kernel and route ct's mixed-radix and wide FFT features: the
  bounds of the f32 (and bf16) features above (the same function as the CT plain
  version, summed in another order); route fft's wide body the same,
  against the plain chain;
- the stage cuts of the CT and FFT kernels (B, 128): `dev.r3_omission.
  TOLERANCES`, each stage's bound with its reason (f32 sums in another
  order; from the log on, the f32 feature bound summed over 30 frames).
- the register and wide bodies at many filters and coefficients, fused
  with the trimmed DCT region or with the cepstrum kernel: within the
  feature bound of the float64 features plus the slack f32 rounding
  carries through the log of each filter's power, and so must the plain
  version be (`dev.cepstrum_ablation.check_conditioned`: from 80 filters
  at n_fft 1024 a filter covers one bin, whose power in a quiet frame can
  be 1e-15 of the frame's, and the log of its f32 rounding moves a
  coefficient past the bare bound in the plain f32 chain too); the
  cepstrum kernel alone: the feature bounds above against cepstrum_plain
  (the same f32 products summed in another order);
- the stream tick and the Listener, card vs CPU: scores atol 1e-3 (the
  scores f32 bound above), the feature buffer within the f32 feature bound
  (the frame features are the plain chain's products on both devices),
  the audio ring and fill equal.
cuDNN runs float32 convs in TF32 unless told otherwise: the fixture turns
TF32 off, so the plain versions' convs are float32.
"""
import glob
import os
import wave

import numpy as np
import pytest
import torch

from tpu_speech_commands_torch.models.cnn import SimpleCNN, SimpleCNNLite
from tpu_speech_commands_torch.models.rnn import SimpleGRU, SimpleLSTM
from tpu_speech_commands_torch.dev import (cepstrum_ablation,
                                           pallas_experiments, r3_experiments,
                                           r3_frontend_variants, r3_omission,
                                           r3_stage2, r3_widecell,
                                           r4_mxu_stage1)
from tpu_speech_commands_torch.ops import (cepstrum_plan, cnn_kernel, ct_kernel,
                                           dense_dft_kernel, fft_plan,
                                           frontend_kernel, load_kernel,
                                           omission_kernel, rnn_kernel)
from tpu_speech_commands_torch.frontend.dsp import Frontend
from tpu_speech_commands_torch.frontend.filterbanks import dct_t_matrix
from tpu_speech_commands_torch.ops.cnn_lowering import lower_block1
from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
from tpu_speech_commands_torch.ops.rnn_kernel import GRUClassifier, LSTMClassifier
from tpu_speech_commands_torch.parallel import make_mesh
from tpu_speech_commands_torch.params import ListenerParams, pr
from tpu_speech_commands_torch.serving import make_batch_scorer

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRU_CKPT = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")
LSTM_CKPT = os.path.join(REPO, "pretrained", "direction_simple_lstm.npz")
CNN_CKPTS = {m: os.path.join(REPO, "pretrained", f"direction_{m}.npz")
             for m in ("simple_cnn", "simple_cnn_lite")}
# the default MFCC shape, the use_delta shape (stride 2 over an even width
# in block 3) and odd dimensions (the VALID pools drop a row and a column)
CNN_SHAPES = [(30, 20), (30, 40), (29, 21)]

CONFIGS = {
    "mfcc": ({}, "mfcc"),
    "bark": ({}, "bark"),
    "use_delta": ({"use_delta": True}, "mfcc"),
    "window_t=0.05": ({"window_t": 0.05}, "mfcc"),
    "odd_hop": ({"hop_t": 0.03}, "mfcc"),
    "alt_512": ({"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                 "n_filt": 26, "n_mfcc": 13}, "mfcc"),
}
# the FFT kernel also at both ends of its register body's sizes (n_fft 128
# and 4096) and at a size its radix-2 body takes (64)
FFT_CONFIGS = {
    **CONFIGS,
    "n_fft=128": ({"n_fft": 128, "window_t": 0.008}, "mfcc"),
    "n_fft=4096": ({"n_fft": 4096}, "mfcc"),
    "n_fft=64 radix2": ({"n_fft": 64, "window_t": 0.004}, "mfcc"),
}


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """Checkpoint loads write the port's global `pr`."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


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


def _frontend_counter(p):
    """The launch count of the FFT kernel's body that config `p` takes."""
    if frontend_kernel.fft_body(p) == "radix2":
        return frontend_kernel.RADIX2
    return frontend_kernel.mfcc_frontend_cuda


@pytest.mark.parametrize("name", sorted(FFT_CONFIGS))
@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_frontend_kernel_matches_plain(cuda_device, name, audio_dtype,
                                       out_dtype):
    """B = 13: one block a window, so no tile multiple matters."""
    kw, feature_type = FFT_CONFIGS[name]
    p = ListenerParams(**kw)
    assert (frontend_kernel.fft_body(p) == "radix2") == name.endswith("radix2")
    clips, _ = _clips()
    rows = clips[np.arange(13) % 8].astype(np.float32) / 32768.0
    audio = rows * np.linspace(0.3, 1.5, 13, dtype=np.float32)[:, None]
    if audio_dtype == "int16":
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    audio = torch.tensor(audio, device=cuda_device)
    fe = MfccFrontend(p, feature_type, cuda_device, out_dtype=out_dtype)
    counter = _frontend_counter(p)
    before = counter.launches
    got = fe(audio, 0.8)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.shape == (13, p.n_features, p.feature_size)
    assert got.dtype == out_dtype
    want = fe.plain(audio, 0.8).to(out_dtype)
    rtol = 1e-3 if out_dtype == torch.float32 else 1e-3 + 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-3)


@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_frontend_kernel_ragged_batch(cuda_device, audio_dtype):
    """B = 1000 windows at the default config: no batch multiple matters."""
    p = ListenerParams()
    audio = torch.tensor(_ct_audio(audio_dtype, batch=1000), device=cuda_device)
    fe = MfccFrontend(p, "mfcc", cuda_device)
    got = fe(audio, 1.1)
    torch.cuda.synchronize()
    assert got.shape == (1000, 30, 20) and torch.isfinite(got).all()
    torch.testing.assert_close(got, fe.plain(audio, 1.1), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_frontend_kernel_unaligned_frames(cuda_device, audio_dtype):
    """hop 481 (odd frame starts), rows of 16001 samples (an odd pitch) and
    a row base one sample off: the pair loads fall back to scalar loads
    inside the kernel."""
    p = ListenerParams(hop_t=481 / 16000)
    rows = np.pad(_ct_audio(audio_dtype), ((0, 0), (0, 1)))
    flat = torch.zeros(rows.size + 1, dtype=torch.float32
                       if audio_dtype == "float32" else torch.int16)
    flat[1:] = torch.tensor(rows.ravel())
    fe = MfccFrontend(p, "mfcc", cuda_device)
    for audio in (torch.tensor(rows, device=cuda_device),
                  flat.to(cuda_device)[1:].view(rows.shape)):
        got = fe(audio, 0.9)
        torch.testing.assert_close(got, fe.plain(audio, 0.9), rtol=1e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_register_and_radix2_bodies_agree(cuda_device, out_dtype):
    """The default config through both bodies of the FFT kernel (the A/B
    chip_smoke.py times): within the feature bound of each other, each
    counted to its own launch count."""
    p = ListenerParams()
    audio = torch.tensor(_ct_audio("float32", batch=64), device=cuda_device)
    consts = frontend_kernel.KernelConstants(p, "mfcc", cuda_device)
    gain = torch.full((1,), 1.2, dtype=torch.float32, device=cuda_device)
    before = (frontend_kernel.mfcc_frontend_cuda.launches,
              frontend_kernel.RADIX2.launches)
    new = frontend_kernel.mfcc_frontend_cuda(audio, gain, consts, p, out_dtype)
    old = frontend_kernel.mfcc_frontend_cuda(audio, gain, consts, p, out_dtype,
                                             _radix2=True)
    torch.cuda.synchronize()
    assert (frontend_kernel.mfcc_frontend_cuda.launches,
            frontend_kernel.RADIX2.launches) == (before[0] + 1, before[1] + 1)
    rtol = 1e-3 if out_dtype == torch.float32 else 1e-3 + 2.0 ** -7
    torch.testing.assert_close(new.float(), old.float(), rtol=rtol, atol=2e-3)


def test_frontend_kernel_rejects_what_it_cannot_take(cuda_device):
    fe = MfccFrontend(ListenerParams(), "mfcc", cuda_device)
    with pytest.raises(TypeError):
        fe(torch.zeros(2, 16000, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        fe(torch.zeros(2, 32000, device=cuda_device)[:, ::2])  # strided
    with pytest.raises(ValueError):
        fe(torch.zeros(2, 8000, device=cuda_device))  # too short
    assert fe(torch.zeros(0, 16000, device=cuda_device)).shape == (0, 30, 20)


def _random_gru(d_in, units, num_layers, seed, device):
    model = SimpleGRU(5, d_in, units, num_layers)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.tensor(0.1 * rng.standard_normal(tuple(prm.shape)),
                                   dtype=torch.float32))
    return model.to(device).eval()


def _gru_close(got, want, compute_dtype):
    assert torch.isfinite(got).all()
    atol = 1e-4 if compute_dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("batch", [1, 16, 17, 37, 8192])
@pytest.mark.parametrize("d_in", [3, 20, 40])
@pytest.mark.parametrize("units", [4, 16, 48, 64])
def test_gru_kernel_matches_plain(cuda_device, units, d_in, batch, num_layers,
                                  compute_dtype, x_dtype):
    """The tile kernel at every width up to its cap (64: U 4 and 16 run on
    padded units), ragged batches (17, 37: a warp with idle rows), both
    modes and both feature types.  Weights from a numpy seed."""
    model = _random_gru(d_in, units, num_layers, units + d_in, cuda_device)
    rng = np.random.default_rng(batch)
    x = torch.tensor(rng.standard_normal((batch, 30, d_in)),
                     dtype=torch.float32, device=cuda_device).to(x_dtype)
    before = (rnn_kernel.gru_layer_cuda.launches, rnn_kernel.GRU_SIMT.launches)
    got = GRUClassifier(model, compute_dtype)(x)
    torch.cuda.synchronize()
    assert (rnn_kernel.gru_layer_cuda.launches,
            rnn_kernel.GRU_SIMT.launches) == (before[0] + num_layers, before[1])
    assert got.shape == (batch, 5) and got.dtype == torch.float32
    with torch.no_grad():
        want = model(x.float(), compute_dtype)
    _gru_close(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_gru_over_the_cap_runs_the_simt_kernel(cuda_device, compute_dtype):
    """U = 80 pads past the tile kernel's 64: the SIMT kernel serves it and
    counts, the tile kernel does not."""
    from tpu_speech_commands_torch.ops import gru_plan

    assert gru_plan.gru_kernel_for(20, 80) == "simt"
    model = _random_gru(20, 80, 1, 3, cuda_device)
    x = torch.tensor(np.random.default_rng(0).standard_normal((37, 30, 20)),
                     dtype=torch.float32, device=cuda_device)
    before = (rnn_kernel.gru_layer_cuda.launches, rnn_kernel.GRU_SIMT.launches)
    got = GRUClassifier(model, compute_dtype)(x)
    torch.cuda.synchronize()
    assert (rnn_kernel.gru_layer_cuda.launches,
            rnn_kernel.GRU_SIMT.launches) == (before[0], before[1] + 1)
    with torch.no_grad():
        want = model(x, compute_dtype)
    _gru_close(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_gru_simt_kernel_matches_the_tile_kernel(cuda_device, compute_dtype):
    """The A/B pair at the shipped shape (D 20, U 48), B = 1000: the SIMT
    kernel through `_simt=True`, each against the plain version."""
    model = _random_gru(20, 48, 1, 5, cuda_device)
    cell, head = model.backbone.gru_unit_0, model.score_predict
    x = torch.tensor(np.random.default_rng(1).standard_normal((1000, 30, 20)),
                     dtype=torch.float32, device=cuda_device).to(compute_dtype)
    args = (x, cell.kernel, cell.recurrent_kernel, cell.bias_input,
            cell.bias_recurrent, head.kernel, head.bias, compute_dtype)
    before = (rnn_kernel.gru_layer_cuda.launches, rnn_kernel.GRU_SIMT.launches)
    tile = rnn_kernel.gru_layer_cuda(*args)
    simt = rnn_kernel.gru_layer_cuda(*args, _simt=True)
    torch.cuda.synchronize()
    assert (rnn_kernel.gru_layer_cuda.launches,
            rnn_kernel.GRU_SIMT.launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want = model(x.float(), compute_dtype)
    _gru_close(tile, want, compute_dtype)
    _gru_close(simt, want, compute_dtype)


def test_gru_reciprocal_is_the_true_divide(cuda_device):
    """The tile kernel's sigmoid takes a reciprocal without the division's
    branch: bit for bit 1.0f / d on every float of [1, inf], the range of
    its denominators 1 + exp(-v)."""
    assert rnn_kernel.gru_rcp_mismatches(cuda_device) == 0


def test_gru_wrapper_rejects_what_it_cannot_take(cuda_device):
    from tpu_speech_commands_torch.ops import gru_plan

    model = _random_gru(20, 48, 1, 6, cuda_device)
    cell = model.backbone.gru_unit_0
    x = torch.zeros(4, 30, 20, device=cuda_device)
    weights = (cell.kernel, cell.recurrent_kernel, cell.bias_input,
               cell.bias_recurrent)
    pack16 = gru_plan.pack_gru_weights(*weights, torch.bfloat16)
    with pytest.raises(ValueError, match="pack"):  # packed for bf16
        rnn_kernel.gru_layer_cuda(x, *weights, pack=pack16)
    with pytest.raises(TypeError):
        rnn_kernel.gru_layer_cuda(x.double(), *weights)
    with pytest.raises(ValueError):
        rnn_kernel.gru_layer_cuda(x[:, :, :19], *weights)
    with pytest.raises(RuntimeError, match="CUDA error"):  # no such split
        rnn_kernel.gru_layer_cuda(x, *weights, _split=(16, 9))
    assert rnn_kernel.gru_layer_cuda(x[:0], *weights).shape == (0, 30, 48)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_scorer_runs_both_kernels(cuda_device, compute_dtype):
    audio, labels = _clips()
    scorer = make_batch_scorer(GRU_CKPT, cuda_device, compute_dtype)
    assert scorer.paths["frontend"].startswith("cuda-mfcc")
    assert scorer.paths["classifier"] == "cuda-gru"
    frontend_kernel.mfcc_frontend_cuda.launches = 0
    rnn_kernel.gru_layer_cuda.launches = 0
    rnn_kernel.GRU_SIMT.launches = 0
    got = scorer(torch.tensor(audio, device=cuda_device)).cpu()
    assert frontend_kernel.mfcc_frontend_cuda.launches == 1
    # the tile kernel served the scorer, not the SIMT one
    assert rnn_kernel.gru_layer_cuda.launches == 1
    assert rnn_kernel.GRU_SIMT.launches == 0
    assert torch.isfinite(got).all()
    assert [scorer.classes[i] for i in got.argmax(-1)] == labels
    want = make_batch_scorer(GRU_CKPT, "cpu", compute_dtype)(audio)
    atol = 1e-3 if compute_dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("ckpt", [GRU_CKPT, CNN_CKPTS["simple_cnn"]])
def test_scorer_split_over_two_shards_of_one_card(cuda_device, ckpt):
    """make_batch_scorer(mesh=) with two batch shards on cuda:0: each kernel
    launches once a shard, and the scores equal the one-device scorer's
    (the kernels compute a row alone, whatever the batch)."""
    audio, labels = _clips()
    scorer = make_batch_scorer(ckpt, mesh=make_mesh(
        devices=[cuda_device, cuda_device]))
    assert scorer.paths["parallel"] == "shards x2"
    classifier = {"cuda-gru": rnn_kernel.gru_layer_cuda,
                  "cuda-cnn": cnn_kernel.cnn_classifier_cuda}[
                      scorer.paths["classifier"]]
    frontend_kernel.mfcc_frontend_cuda.launches = classifier.launches = 0
    got = scorer(torch.tensor(audio, device=cuda_device))
    assert frontend_kernel.mfcc_frontend_cuda.launches == 2
    assert classifier.launches == 2
    assert [scorer.classes[i] for i in got.argmax(-1)] == labels
    want = make_batch_scorer(ckpt, cuda_device)(
        torch.tensor(audio, device=cuda_device))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible by the 2-device"):
        scorer(torch.tensor(audio[:3], device=cuda_device))


def _random_cnn(model_type, h, w, seed, device):
    """A CNN with weights and BatchNorm statistics from a numpy seed; some
    BatchNorm scales are negative, as after training."""
    cls = SimpleCNNLite if model_type == "simple_cnn_lite" else SimpleCNN
    model = cls(5, h, w)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("bn.var"):
                val = rng.uniform(0.5, 2.0, t.shape)
            elif name.endswith("bn.scale"):
                val = rng.normal(1.0, 0.6, t.shape)
            else:
                fan_in = int(np.prod(t.shape[:-1])) if t.ndim > 1 else 10
                val = rng.standard_normal(t.shape) / np.sqrt(fan_in)
            t.copy_(torch.tensor(val, dtype=torch.float32))
    return model.to(device).eval()


def _cnn_features(batch, h, w, seed, device):
    rng = np.random.default_rng(seed)
    return torch.tensor(4.0 * rng.standard_normal((batch, h, w)),
                        dtype=torch.float32, device=device)


@pytest.mark.parametrize("shape", CNN_SHAPES)
@pytest.mark.parametrize("model_type", ["simple_cnn", "simple_cnn_lite"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cnn_classifier_kernel_matches_plain(cuda_device, shape, model_type,
                                             compute_dtype):
    """B = 37: a ragged last tile (of 16 windows in bf16; of 8 in f32 at
    30 x 20 and 29 x 21, of 6 at 30 x 40)."""
    model = _random_cnn(model_type, *shape, seed=sum(shape), device=cuda_device)
    x = _cnn_features(37, *shape, seed=3, device=cuda_device).to(compute_dtype)
    cls = cnn_kernel.CNNClassifier(model, compute_dtype)
    before = cnn_kernel.cnn_classifier_cuda.launches
    got = cls(x)
    torch.cuda.synchronize()
    assert cnn_kernel.cnn_classifier_cuda.launches == before + 1
    assert got.shape == (37, 5) and got.dtype == torch.float32
    want = cnn_kernel.cnn_classifier_plain(cls.consts, x)
    if compute_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        with torch.no_grad():
            torch.testing.assert_close(got, model(x), rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2)


def _check_cnn_logits(got, want, compute_dtype):
    assert torch.isfinite(got).all()
    if compute_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2)


@pytest.mark.parametrize("shape", CNN_SHAPES)
@pytest.mark.parametrize("model_type", ["simple_cnn", "simple_cnn_lite"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cnn_classifier_simt_kernel_matches_plain(cuda_device, shape,
                                                  model_type, compute_dtype):
    """The SIMT kernel kept for the A/B (`_simt=True`), B = 37."""
    model = _random_cnn(model_type, *shape, seed=sum(shape), device=cuda_device)
    x = _cnn_features(37, *shape, seed=3, device=cuda_device).to(compute_dtype)
    consts = cnn_kernel.CNNClassifier(model, compute_dtype).consts
    simt, gemm = cnn_kernel.SIMT.launches, cnn_kernel.cnn_classifier_cuda.launches
    got = cnn_kernel.cnn_classifier_cuda(x, consts, _simt=True)
    torch.cuda.synchronize()
    assert cnn_kernel.SIMT.launches == simt + 1
    assert cnn_kernel.cnn_classifier_cuda.launches == gemm
    assert got.shape == (37, 5) and got.dtype == torch.float32
    _check_cnn_logits(got, cnn_kernel.cnn_classifier_plain(consts, x),
                      compute_dtype)


@pytest.mark.parametrize("batch", ["one", "many"])
@pytest.mark.parametrize("model_type", ["simple_cnn", "simple_cnn_lite"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cnn_classifier_ragged_batches(cuda_device, batch, model_type,
                                       compute_dtype):
    """B = 1, and a batch over several waves of blocks whose last tile is
    ragged: both kernels against the plain version, each launch counted
    where it belongs."""
    model = _random_cnn(model_type, 30, 20, seed=21, device=cuda_device)
    consts = cnn_kernel.CNNClassifier(model, compute_dtype).consts
    n = 1
    if batch == "many":
        n = 3001
        assert n % consts.plan.tile and consts.plan.tile > 1
    x = _cnn_features(n, 30, 20, seed=6, device=cuda_device).to(compute_dtype)
    want = cnn_kernel.cnn_classifier_plain(consts, x)
    for simt in (False, True):
        counter = cnn_kernel.SIMT if simt else cnn_kernel.cnn_classifier_cuda
        before = counter.launches
        got = cnn_kernel.cnn_classifier_cuda(x, consts, _simt=simt)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        _check_cnn_logits(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cnn_classifier_takes_a_window_too_large_for_the_deep_ring(
        cuda_device, compute_dtype):
    """198 x 40 features (2 s at a 10 ms hop, with deltas), which the SIMT
    kernel's shared memory took: in f32 the plan takes unpadded pixels and 2
    weight slots.  Both kernels against the plain version, B = 5."""
    model = _random_cnn("simple_cnn", 198, 40, seed=8, device=cuda_device)
    consts = cnn_kernel.CNNClassifier(model, compute_dtype).consts
    if compute_dtype == torch.float32:
        assert consts.plan.ring == 2
    x = _cnn_features(5, 198, 40, seed=9, device=cuda_device).to(compute_dtype)
    want = cnn_kernel.cnn_classifier_plain(consts, x)
    for simt in (False, True):
        counter = cnn_kernel.SIMT if simt else cnn_kernel.cnn_classifier_cuda
        before = counter.launches
        got = cnn_kernel.cnn_classifier_cuda(x, consts, _simt=simt)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        _check_cnn_logits(got, want, compute_dtype)


def test_cnn_classifier_refuses_a_config_its_plan_cannot_take(cuda_device):
    """One 200 x 200 window's activations exceed a block's shared memory:
    the GEMM kernel raises, by config, and does not run the SIMT kernel."""
    model = _random_cnn("simple_cnn", 200, 200, seed=2, device=cuda_device)
    cls = cnn_kernel.CNNClassifier(model)
    simt = cnn_kernel.SIMT.launches
    with pytest.raises(ValueError, match="shared memory"):
        cls(_cnn_features(2, 200, 200, seed=1, device=cuda_device))
    assert cnn_kernel.SIMT.launches == simt


def _check_block1(got, want, compute_dtype):
    assert torch.isfinite(got).all()
    if compute_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2)


@pytest.mark.parametrize("shape", CNN_SHAPES)
@pytest.mark.parametrize("model_type", ["simple_cnn", "simple_cnn_lite"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 13, 37, 1000, 8192])
@pytest.mark.parametrize("simt", [False, True])
def test_cnn_block1_kernel_matches_plain(cuda_device, shape, model_type,
                                         compute_dtype, x_dtype, batch, simt):
    """The block-1 kernel and its SIMT kernel (`_simt=True`), each against
    the plain version; B 1 .. 8192 covers the persistent loop's ragged last
    tile and blocks with one tile or several.  Each launch counts where it
    belongs."""
    model = _random_cnn(model_type, *shape, seed=7, device=cuda_device)
    x = _cnn_features(batch, *shape, seed=4, device=cuda_device).to(x_dtype)
    stage = cnn_kernel.StageTensors(
        lower_block1(model.variables(), model.separable, *shape),
        cuda_device, compute_dtype)
    assert cnn_kernel.block1_kernel_for(stage, x_dtype) == "cnn_block1"
    new, old = cnn_kernel.cnn_block1_cuda.launches, cnn_kernel.BLOCK1_SIMT.launches
    got = cnn_kernel.cnn_block1_cuda(x, stage, _simt=simt)
    torch.cuda.synchronize()
    assert cnn_kernel.cnn_block1_cuda.launches == new + (not simt)
    assert cnn_kernel.BLOCK1_SIMT.launches == old + simt
    assert got.shape == (batch, shape[0] // 2, shape[1] // 2, 16)
    _check_block1(got, cnn_kernel.cnn_block1_plain(stage, x), compute_dtype)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cnn_block1_kernel_takes_unaligned_features(cuda_device, x_dtype,
                                                    compute_dtype):
    """Features that start off a 16-byte boundary (a view one element into
    a larger tensor) and windows whose bytes are no multiple of 16 (29 x
    21): the ring's bulk copies take the aligned interior, plain loads the
    rest."""
    model = _random_cnn("simple_cnn", 29, 21, seed=12, device=cuda_device)
    stage = cnn_kernel.StageTensors(
        lower_block1(model.variables(), False, 29, 21), cuda_device,
        compute_dtype)
    flat = _cnn_features(1001, 29, 21, seed=8, device=cuda_device).to(x_dtype)
    x = flat.reshape(-1)[1:1 + 1000 * 29 * 21].view(1000, 29, 21)
    assert x.data_ptr() % 16 and x.is_contiguous()
    before = cnn_kernel.cnn_block1_cuda.launches
    got = cnn_kernel.cnn_block1_cuda(x, stage)
    torch.cuda.synchronize()
    assert cnn_kernel.cnn_block1_cuda.launches == before + 1
    _check_block1(got, cnn_kernel.cnn_block1_plain(stage, x), compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw, kernel", [((200, 200), "cnn_block1_simt"),
                                        ((100, 100), "cnn_block1")])
def test_cnn_block1_window_too_large_for_the_ring(cuda_device, compute_dtype,
                                                  hw, kernel):
    """A 200 x 200 window's ring does not fit a block's shared memory: the
    config sends it to the SIMT kernel (which takes one window up to the
    opt-in limit) before any launch; 100 x 100 stays on the new kernel.
    Both against the plain version, B = 5."""
    model = _random_cnn("simple_cnn", *hw, seed=2, device=cuda_device)
    stage = cnn_kernel.StageTensors(
        lower_block1(model.variables(), False, *hw), cuda_device, compute_dtype)
    x = _cnn_features(5, *hw, seed=1, device=cuda_device)
    assert cnn_kernel.block1_kernel_for(stage, x.dtype) == kernel
    new, old = cnn_kernel.cnn_block1_cuda.launches, cnn_kernel.BLOCK1_SIMT.launches
    got = cnn_kernel.cnn_block1_cuda(x, stage)
    torch.cuda.synchronize()
    simt = kernel == "cnn_block1_simt"
    assert cnn_kernel.cnn_block1_cuda.launches == new + (not simt)
    assert cnn_kernel.BLOCK1_SIMT.launches == old + simt
    _check_block1(got, cnn_kernel.cnn_block1_plain(stage, x), compute_dtype)


@pytest.mark.parametrize("model_type", ["simple_cnn", "simple_cnn_lite"])
def test_fused_cnn_forward_matches_model(cuda_device, model_type):
    model = _random_cnn(model_type, 30, 20, seed=11, device=cuda_device)
    x = _cnn_features(37, 30, 20, seed=5, device=cuda_device)
    before = cnn_kernel.cnn_block1_cuda.launches
    simt = cnn_kernel.BLOCK1_SIMT.launches
    got = cnn_kernel.make_fused_cnn_forward(model)(x[..., None])
    torch.cuda.synchronize()
    assert cnn_kernel.cnn_block1_cuda.launches == before + 1
    assert cnn_kernel.BLOCK1_SIMT.launches == simt
    with torch.no_grad():
        torch.testing.assert_close(got, model(x), rtol=1e-5, atol=1e-4)


def test_cnn_wrappers_reject_what_they_cannot_take(cuda_device):
    model = _random_cnn("simple_cnn", 30, 20, seed=1, device=cuda_device)
    consts = cnn_kernel.CNNClassifier(model).consts
    stage = consts.stages[0]
    good = _cnn_features(2, 30, 20, seed=1, device=cuda_device)
    for launch, arg in ((cnn_kernel.cnn_classifier_cuda, consts),
                        (cnn_kernel.cnn_block1_cuda, stage)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(good.cpu(), arg)
        with pytest.raises(TypeError):
            launch(good.double(), arg)
        with pytest.raises(ValueError):
            launch(_cnn_features(2, 30, 21, seed=1, device=cuda_device), arg)
        with pytest.raises(ValueError):
            launch(good.transpose(0, 1).contiguous().transpose(0, 1), arg)
        assert launch(good[:0], arg).shape[0] == 0
    with pytest.raises(ValueError, match="block-1 kernel"):
        cnn_kernel.cnn_block1_cuda(good, consts.stages[1])  # block 2


@pytest.mark.parametrize("model_type", sorted(CNN_CKPTS))
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cnn_scorer_runs_both_kernels(cuda_device, model_type, compute_dtype):
    audio, labels = _clips()
    scorer = make_batch_scorer(CNN_CKPTS[model_type], cuda_device, compute_dtype)
    assert scorer.paths["frontend"].startswith("cuda-mfcc")
    assert scorer.paths["classifier"] == "cuda-cnn"
    frontend_kernel.mfcc_frontend_cuda.launches = 0
    cnn_kernel.cnn_classifier_cuda.launches = 0
    got = scorer(torch.tensor(audio, device=cuda_device)).cpu()
    assert frontend_kernel.mfcc_frontend_cuda.launches == 1
    assert cnn_kernel.cnn_classifier_cuda.launches == 1
    assert [scorer.classes[i] for i in got.argmax(-1)] == labels
    want = make_batch_scorer(CNN_CKPTS[model_type], "cpu", compute_dtype)(audio)
    atol = 1e-3 if compute_dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 13, 1000, 8192])
@pytest.mark.parametrize("mma_sync", [False, True])
def test_fast_math_kernel_matches_plain(cuda_device, name, audio_dtype,
                                        out_dtype, batch, mma_sync):
    """Both fast_math kernels: the wgmma one (the default) and the first
    design (`_mma_sync=True`), each counted apart.  B = 1 (one block of a
    cluster idle), 13 (a ragged last tile of windows), 1000 and 8192."""
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    clips, _ = _clips()
    rows = clips[np.arange(batch) % 8].astype(np.float32) / 32768.0
    audio = rows * np.linspace(0.3, 1.5, batch, dtype=np.float32)[:, None]
    if audio_dtype == "int16":
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    audio = torch.tensor(audio, device=cuda_device)
    fe = MfccFrontend(p, feature_type, cuda_device, out_dtype=out_dtype,
                      fast_math=True)
    gain = torch.full((1,), 0.8, dtype=torch.float32, device=cuda_device)
    counters = (frontend_kernel.dft_frontend_bf16_cuda, frontend_kernel.MMA_SYNC)
    before = [c.launches for c in counters]
    got = frontend_kernel.dft_frontend_bf16_cuda(
        audio, gain, fe.consts, p, out_dtype, _mma_sync=mma_sync)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [
        before[0] + (not mma_sync), before[1] + mma_sync]
    assert got.shape == (batch, p.n_features, p.feature_size)
    assert got.dtype == out_dtype
    assert torch.isfinite(got.float()).all()
    want = fe.plain(audio, 0.8).to(out_dtype)
    rtol = 1e-3 if out_dtype == torch.float32 else 1e-3 + 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-3)


@pytest.mark.parametrize("n_samples", [16001, 16004])
@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_fast_math_kernel_takes_rows_of_any_length(cuda_device, n_samples,
                                                   audio_dtype):
    """Rows whose length leaves them unaligned to 16 bytes (16001 samples,
    and 16004 int16): the wgmma kernel stages them by plain loads, not by
    bulk copies, and holds to the plain version as at 16000."""
    p = ListenerParams()
    rng = np.random.default_rng(7)
    audio = 0.3 * rng.standard_normal((13, n_samples)).astype(np.float32)
    if audio_dtype == "int16":
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    audio = torch.tensor(audio, device=cuda_device)
    fe = MfccFrontend(p, "mfcc", cuda_device, fast_math=True)
    got = fe(audio, 0.8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fe.plain(audio, 0.8), rtol=1e-3, atol=2e-3)


def test_fast_math_kernel_rejects_what_it_cannot_take(cuda_device):
    fe = MfccFrontend(ListenerParams(), "mfcc", cuda_device, fast_math=True)
    with pytest.raises(TypeError):
        fe(torch.zeros(2, 16000, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        fe(torch.zeros(2, 32000, device=cuda_device)[:, ::2])  # strided
    with pytest.raises(ValueError):
        fe(torch.zeros(2, 8000, device=cuda_device))  # too short
    with pytest.raises(ValueError, match="multiple of 8"):
        MfccFrontend(ListenerParams(hop_t=0.0101), "mfcc", cuda_device,
                     fast_math=True)
    assert fe(torch.zeros(0, 16000, device=cuda_device)).shape == (0, 30, 20)


def _random_lstm(d_in, units, num_layers, seed, device):
    model = SimpleLSTM(5, d_in, units, num_layers)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.tensor(0.1 * rng.standard_normal(tuple(prm.shape)),
                                   dtype=torch.float32))
    return model.to(device).eval()


def _lstm_counts():
    return rnn_kernel.lstm_layer_cuda.launches, rnn_kernel.LSTM_SIMT.launches


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("batch", [1, 16, 17, 37, 8192])
@pytest.mark.parametrize("d_in", [3, 20, 40])
@pytest.mark.parametrize("units", [4, 16, 48, 64])
def test_lstm_kernel_matches_plain(cuda_device, units, d_in, batch, num_layers,
                                   compute_dtype, x_dtype):
    """The tile kernel at every width up to its cap (64: U 4 and 16 run on
    padded units), ragged batches (17, 37: a warp with idle rows), both
    modes and both feature types.  Weights from a numpy seed."""
    model = _random_lstm(d_in, units, num_layers, 10 + units + d_in,
                         cuda_device)
    rng = np.random.default_rng(batch)
    x = torch.tensor(rng.standard_normal((batch, 30, d_in)),
                     dtype=torch.float32, device=cuda_device).to(x_dtype)
    before = _lstm_counts()
    got = LSTMClassifier(model, compute_dtype)(x)
    torch.cuda.synchronize()
    assert _lstm_counts() == (before[0] + num_layers, before[1])
    assert got.shape == (batch, 5) and got.dtype == torch.float32
    with torch.no_grad():
        want = model(x.float(), compute_dtype)
    _gru_close(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_lstm_over_the_cap_runs_the_simt_kernel(cuda_device, compute_dtype):
    """U = 80 pads past the tile kernel's 64: the SIMT kernel serves it and
    counts, the tile kernel does not."""
    from tpu_speech_commands_torch.ops import lstm_plan

    assert lstm_plan.lstm_kernel_for(20, 80) == "simt"
    model = _random_lstm(20, 80, 1, 3, cuda_device)
    x = torch.tensor(np.random.default_rng(0).standard_normal((37, 30, 20)),
                     dtype=torch.float32, device=cuda_device)
    before = _lstm_counts()
    got = LSTMClassifier(model, compute_dtype)(x)
    torch.cuda.synchronize()
    assert _lstm_counts() == (before[0], before[1] + 1)
    with torch.no_grad():
        want = model(x, compute_dtype)
    _gru_close(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_lstm_simt_kernel_matches_the_tile_kernel(cuda_device, compute_dtype):
    """The A/B pair at the shipped shape (D 20, U 48), B = 1000: the SIMT
    kernel through `_simt=True`, each against the plain version."""
    model = _random_lstm(20, 48, 1, 5, cuda_device)
    cell, head = model.backbone.lstm_unit_0, model.score_predict
    x = torch.tensor(np.random.default_rng(1).standard_normal((1000, 30, 20)),
                     dtype=torch.float32, device=cuda_device).to(compute_dtype)
    args = (x, cell.kernel, cell.recurrent_kernel, cell.bias, head.kernel,
            head.bias, compute_dtype)
    before = _lstm_counts()
    with torch.no_grad():
        tile = rnn_kernel.lstm_layer_cuda(*args)
        simt = rnn_kernel.lstm_layer_cuda(*args, _simt=True)
        torch.cuda.synchronize()
        want = model(x.float(), compute_dtype)
    assert _lstm_counts() == (before[0] + 1, before[1] + 1)
    _gru_close(tile, want, compute_dtype)
    _gru_close(simt, want, compute_dtype)


def test_lstm_wrapper_rejects_what_it_cannot_take(cuda_device):
    from tpu_speech_commands_torch.ops import lstm_plan

    cell = SimpleLSTM(5, 20, 48).to(cuda_device).backbone.lstm_unit_0
    weights = (cell.kernel.detach(), cell.recurrent_kernel.detach(),
               cell.bias.detach())
    good = torch.zeros(2, 30, 20, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rnn_kernel.lstm_layer_cuda(good.cpu(), *weights)
    with pytest.raises(TypeError):
        rnn_kernel.lstm_layer_cuda(good.double(), *weights)
    with pytest.raises(ValueError):
        rnn_kernel.lstm_layer_cuda(good.transpose(0, 1).contiguous()
                                   .transpose(0, 1), *weights)
    with pytest.raises(ValueError, match="kernel"):
        rnn_kernel.lstm_layer_cuda(torch.zeros(2, 30, 21, device=cuda_device),
                                   *weights)
    pack16 = lstm_plan.pack_lstm_weights(*weights, torch.bfloat16)
    with pytest.raises(ValueError, match="pack"):  # packed for bf16
        rnn_kernel.lstm_layer_cuda(good, *weights, pack=pack16)
    assert rnn_kernel.lstm_layer_cuda(good[:0], *weights).shape == (0, 30, 48)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_lstm_scorer_runs_both_kernels(cuda_device, compute_dtype):
    audio, labels = _clips()
    scorer = make_batch_scorer(LSTM_CKPT, cuda_device, compute_dtype)
    assert scorer.paths == {"frontend": "cuda-mfcc", "classifier": "cuda-lstm"}
    frontend_kernel.mfcc_frontend_cuda.launches = 0
    rnn_kernel.lstm_layer_cuda.launches = rnn_kernel.LSTM_SIMT.launches = 0
    got = scorer(torch.tensor(audio, device=cuda_device)).cpu()
    assert frontend_kernel.mfcc_frontend_cuda.launches == 1
    assert _lstm_counts() == (1, 0)
    assert [scorer.classes[i] for i in got.argmax(-1)] == labels
    want = make_batch_scorer(LSTM_CKPT, "cpu", compute_dtype)(audio)
    atol = 1e-3 if compute_dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def _wide_counts():
    """Launches of the projection (either design), the tile kernels and the
    SIMT kernels."""
    from tpu_speech_commands_torch.ops import rnn_projection

    return (rnn_projection.PROJECTION.launches
            + rnn_projection.PROJECTION_MMA_SYNC.launches,
            rnn_kernel.gru_layer_cuda.launches + rnn_kernel.lstm_layer_cuda.launches,
            rnn_kernel.GRU_SIMT.launches + rnn_kernel.LSTM_SIMT.launches)


def _projection_case(device, d_in, gates, units, batch, compute_dtype,
                     x_dtype, design, shift=0):
    """One launch of the projection by `design` ("wgmma": the kernel,
    csrc/rnn_projection_wgmma.cu, on x converted to the mode's type;
    "mma_sync": its first design, `_mma_sync=True`), held first to finite
    values, then, with `rnn_projection_plain`, to `exact_projection`'s
    bound of the float64 XW; `shift` elements into x's buffer (a row start
    off a 16-byte boundary)."""
    from tpu_speech_commands_torch.ops import rnn_projection as rp

    rng = np.random.default_rng(d_in + units)
    kernel = torch.tensor(rng.standard_normal((d_in, gates * units)) /
                          np.sqrt(d_in), dtype=torch.float32,
                          device=device)
    bias = torch.tensor(rng.standard_normal(gates * units),
                        dtype=torch.float32, device=device)
    n = batch * 23 * d_in
    x = torch.tensor(rng.standard_normal(shift + n), dtype=torch.float32,
                     device=device).to(x_dtype)[shift:].view(batch, 23, d_in)
    pack = rp.pack_projection(kernel, bias, units, compute_dtype)
    mma_sync = design == "mma_sync"
    counter = rp.PROJECTION_MMA_SYNC if mma_sync else rp.PROJECTION
    before = counter.launches
    got = rp.rnn_projection_cuda(x, pack, _mma_sync=mma_sync)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = rp.rnn_projection_plain(x, kernel, bias, units, compute_dtype)
    assert got.shape == want.shape == (-(-batch // 16), 23,
                                       gates * rp.padded(units) // 8, 32, 4)
    assert torch.isfinite(got).all()
    exact, bound = rp.exact_projection(x, kernel, bias, units, compute_dtype)
    assert ((got.double() - exact).abs() <= bound).all()
    assert ((want.double() - exact).abs() <= bound).all()


@pytest.mark.parametrize("design", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [37, 1000])
@pytest.mark.parametrize("gates,units", [(3, 48), (4, 48), (3, 16), (4, 64),
                                         (3, 64), (4, 32)])
@pytest.mark.parametrize("d_in", [33, 80, 300, 600])
def test_rnn_projection_kernel_matches_plain(cuda_device, d_in, gates, units,
                                             batch, compute_dtype, x_dtype,
                                             design):
    """Both designs of the projection in the tile layout: every N they
    serve, D not a multiple of a stage (33, 300, 600; 33 odd: bf16 rows at
    odd offsets, which the first design stages through registers and the
    kernel reads at odd shifts) and a ragged batch (37: a tile of 5
    windows); x in the other type than the mode's (the kernel's wrapper
    converts it, the first design converts it where it stages it).  Kernel
    and `rnn_projection_plain` each within
    `exact_projection`'s bound of the float64 XW (an f32 sum of D products,
    plus 3xTF32's dropped terms in f32 mode)."""
    _projection_case(cuda_device, d_in, gates, units, batch, compute_dtype,
                     x_dtype, design)


@pytest.mark.parametrize("design", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gates,units", [(3, 48), (4, 48), (3, 16), (4, 64),
                                         (3, 64), (4, 32)])
def test_rnn_projection_at_the_timed_batch(cuda_device, gates, units,
                                           compute_dtype, design):
    """The same at B 8192 and D 300, the shape phase 5 of chip_smoke.py
    times (x in the mode's type)."""
    _projection_case(cuda_device, 300, gates, units, 8192, compute_dtype,
                     compute_dtype, design)


@pytest.mark.parametrize("design", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("shift", [1, 2, 3, 5])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in", [33, 300])
def test_rnn_projection_takes_x_off_a_boundary(cuda_device, d_in,
                                               compute_dtype, shift, design):
    """x a view `shift` elements into its buffer, so that no row starts on
    a 16-byte boundary where x does not: the kernel reads each row at its
    address's shift, the first design through its register ring."""
    _projection_case(cuda_device, d_in, 3, 48, 37, compute_dtype,
                     compute_dtype, design, shift)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [37, 8192])
@pytest.mark.parametrize("steps", [23, 30])
@pytest.mark.parametrize("d_in", [80, 300, 600])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_classifiers_take_the_projected_route(cuda_device, cell, d_in,
                                                   steps, batch,
                                                   compute_dtype):
    """Fault 3.10: above 64 features the classifiers run the projection
    and the tile kernel in projected mode (one launch each, the SIMT kernel
    none), at feature sizes the SIMT kernel's block refused from 305 (GRU)
    and 227 (LSTM) at 23 frames; bf16 compute on bf16 features, as the
    bf16 scorer hands them over; the projection is the design
    `projection_design`'s rule names for the mode (f32 the wgmma kernel,
    bf16 its first design).  Against the plain module: the GRU and LSTM
    tolerances above."""
    from tpu_speech_commands_torch.ops import rnn_projection as rp

    random = _random_gru if cell == "gru" else _random_lstm
    classifier = GRUClassifier if cell == "gru" else LSTMClassifier
    model = random(d_in, 48, 1, d_in + steps, cuda_device)
    x = torch.tensor(np.random.default_rng(batch).standard_normal(
        (batch, steps, d_in)), dtype=torch.float32,
        device=cuda_device).to(compute_dtype)
    before = _wide_counts()
    counter = (rp.PROJECTION if compute_dtype in rp.WGMMA_MODES
               else rp.PROJECTION_MMA_SYNC)
    launched = counter.launches
    got = classifier(model, compute_dtype)(x)
    torch.cuda.synchronize()
    assert _wide_counts() == (before[0] + 1, before[1] + 1, before[2])
    assert counter.launches == launched + 1
    assert got.shape == (batch, 5) and got.dtype == torch.float32
    with torch.no_grad():
        want = model(x.float(), compute_dtype)
    _gru_close(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_classifiers_with_the_first_projection(cuda_device, cell,
                                                    compute_dtype):
    """`_mma_sync=True` runs the projected route's projection on its first
    design (csrc/rnn_projection.cu) and nothing else differs: the plain
    module's logits within the GRU and LSTM tolerances above."""
    from tpu_speech_commands_torch.ops import rnn_projection as rp

    random = _random_gru if cell == "gru" else _random_lstm
    classifier = GRUClassifier if cell == "gru" else LSTMClassifier
    model = random(300, 48, 1, 5, cuda_device)
    x = torch.tensor(np.random.default_rng(2).standard_normal((37, 23, 300)),
                     dtype=torch.float32, device=cuda_device).to(compute_dtype)
    before = (rp.PROJECTION.launches, rp.PROJECTION_MMA_SYNC.launches)
    got = classifier(model, compute_dtype, _mma_sync=True)(x)
    torch.cuda.synchronize()
    assert (rp.PROJECTION.launches, rp.PROJECTION_MMA_SYNC.launches) == (
        before[0], before[1] + 1)
    with torch.no_grad():
        want = model(x.float(), compute_dtype)
    _gru_close(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_stacked_layers_and_sequences(cuda_device, cell, compute_dtype):
    """A two-layer model at 150 features and 33 units (padded to 48): layer
    1 takes the projected route and writes its h sequence, layer 2 (33
    features) the tile kernel; f32 features in either mode."""
    random = _random_gru if cell == "gru" else _random_lstm
    classifier = GRUClassifier if cell == "gru" else LSTMClassifier
    model = random(150, 33, 2, 11, cuda_device)
    x = torch.tensor(np.random.default_rng(4).standard_normal((77, 23, 150)),
                     dtype=torch.float32, device=cuda_device)
    before = _wide_counts()
    got = classifier(model, compute_dtype)(x)
    torch.cuda.synchronize()
    assert _wide_counts() == (before[0] + 1, before[1] + 2, before[2])
    with torch.no_grad():
        want = model(x, compute_dtype)
    _gru_close(got, want, compute_dtype)
    cellmod = model.backbone.cells()[0]
    layer = rnn_kernel.gru_layer_cuda if cell == "gru" else \
        rnn_kernel.lstm_layer_cuda
    weights = ((cellmod.kernel, cellmod.recurrent_kernel, cellmod.bias_input,
                cellmod.bias_recurrent) if cell == "gru" else
               (cellmod.kernel, cellmod.recurrent_kernel, cellmod.bias))
    with torch.no_grad():
        seq = layer(x, *weights, compute_dtype=compute_dtype)
        h, hs = torch.zeros(77, 33, device=cuda_device), []
        c = torch.zeros_like(h)
        for t in range(23):
            if cell == "gru":
                h = cellmod(h, x[:, t], compute_dtype)
            else:
                h, c = cellmod((h, c), x[:, t], compute_dtype)
            hs.append(h)
    _gru_close(seq, torch.stack(hs, 1), compute_dtype)


def test_wide_gru_simt_kernel_kept_for_the_a_b(cuda_device):
    """`_simt=True` still runs the SIMT kernel at 300 features (its A/B),
    where its block fits (23 frames), and it agrees with the plain module;
    a feature size past its block raises rather than running another
    kernel."""
    model = _random_gru(300, 48, 1, 8, cuda_device)
    x = torch.tensor(np.random.default_rng(5).standard_normal((37, 23, 300)),
                     dtype=torch.float32, device=cuda_device)
    before = _wide_counts()
    got = GRUClassifier(model, torch.float32, _simt=True)(x)
    torch.cuda.synchronize()
    assert _wide_counts() == (before[0], before[1], before[2] + 1)
    with torch.no_grad():
        _gru_close(got, model(x, torch.float32), torch.float32)
    wide = _random_gru(600, 48, 1, 9, cuda_device)
    x600 = torch.zeros((37, 23, 600), device=cuda_device)
    with pytest.raises(RuntimeError, match="tsc_gru_layer_simt"):
        GRUClassifier(wide, torch.float32, _simt=True)(x600)


def test_wide_wrappers_reject_what_they_cannot_take(cuda_device):
    from tpu_speech_commands_torch.ops import gru_plan
    from tpu_speech_commands_torch.ops import rnn_projection as rp

    cell = SimpleGRU(5, 300, 48).to(cuda_device).backbone.gru_unit_0
    weights = tuple(t.detach() for t in (cell.kernel, cell.recurrent_kernel,
                                         cell.bias_input, cell.bias_recurrent))
    x = torch.zeros(2, 23, 300, device=cuda_device)
    tile = gru_plan.pack_gru_weights(*weights)
    with pytest.raises(ValueError, match="ProjectedPack"):
        rnn_kernel.gru_layer_cuda(x, *weights, pack=tile)
    pack16 = rp.pack_gru_projected(*weights, torch.bfloat16)
    with pytest.raises(ValueError, match="pack"):  # packed for bf16
        rnn_kernel.gru_layer_cuda(x, *weights, pack=pack16)
    with pytest.raises(ValueError, match="features"):
        rp.rnn_projection_cuda(x[:, :, :299].contiguous(), pack16.projection)
    assert rnn_kernel.gru_layer_cuda(x[:0], *weights).shape == (0, 23, 48)


@pytest.mark.parametrize("ckpt", ["simple_gru", "simple_lstm", "simple_cnn",
                                  "simple_cnn_lite"])
def test_fast_math_frontend_into_classifier_kernels(cuda_device, ckpt):
    from tpu_speech_commands_torch.export.inference_loader import load_native

    audio, labels = _clips()
    predictor = load_native(os.path.join(REPO, "pretrained",
                                         f"direction_{ckpt}.npz"), cuda_device)
    cls = {"simple_gru": GRUClassifier, "simple_lstm": LSTMClassifier}.get(
        ckpt, cnn_kernel.CNNClassifier)(predictor.model)
    fe = MfccFrontend(None, predictor.meta.get("feature_type", "mfcc"),
                      cuda_device, fast_math=True)
    before = frontend_kernel.dft_frontend_bf16_cuda.launches
    logits = cls(fe(torch.tensor(audio, device=cuda_device)))
    assert frontend_kernel.dft_frontend_bf16_cuda.launches == before + 1
    assert [predictor.classes[i] for i in logits.argmax(-1).tolist()] == labels


DENSE_CASES = [("combined", {}), ("combined", {"window_t": 0.05}),
               ("combined", {"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                             "n_filt": 26, "n_mfcc": 13}),
               ("halves", {}), ("halves", {"window_t": 0.05, "hop_t": 0.025}),
               ("halves", {"window_t": 0.01, "hop_t": 0.005, "n_fft": 256})]


@pytest.mark.parametrize("variant,kw", DENSE_CASES,
                         ids=[f"{v}-{kw}" for v, kw in DENSE_CASES])
def test_dense_dft_kernel_matches_plain(cuda_device, variant, kw):
    """B = 13: a ragged last tile of windows (and two tiles a window at hop
    80)."""
    p = ListenerParams(**kw)
    clips, _ = _clips()
    rows = clips[np.arange(13) % 8].astype(np.float32) / 32768.0
    audio = torch.tensor(rows * np.linspace(0.3, 1.5, 13, dtype=np.float32)[:, None],
                         device=cuda_device)
    consts = dense_dft_kernel.DenseDftConstants(p, cuda_device)
    launch = getattr(dense_dft_kernel, f"dense_dft_{variant}_cuda")
    plain = getattr(dense_dft_kernel, f"dense_dft_{variant}_plain")
    before = launch.launches
    got = launch(audio, consts)
    torch.cuda.synchronize()
    assert launch.launches == before + 1
    assert got.shape == (13, dense_dft_kernel.n_frames_of(p, 16000), p.n_mfcc)
    torch.testing.assert_close(got, plain(audio, consts), rtol=1e-3, atol=2e-3)


def test_dense_dft_kernels_reject_what_they_cannot_take(cuda_device):
    consts = dense_dft_kernel.DenseDftConstants(ListenerParams(), cuda_device)
    for launch in (dense_dft_kernel.dense_dft_combined_cuda,
                   dense_dft_kernel.dense_dft_halves_cuda):
        with pytest.raises(TypeError):
            launch(torch.zeros(2, 16000, dtype=torch.float64, device=cuda_device),
                   consts)
        with pytest.raises(ValueError):
            launch(torch.zeros(2, 32000, device=cuda_device)[:, ::2], consts)
        with pytest.raises(ValueError):
            launch(torch.zeros(2, 16000), consts)  # on the CPU
        assert launch(torch.zeros(0, 16000, device=cuda_device),
                      consts).shape == (0, 30, 20)
    odd = dense_dft_kernel.DenseDftConstants(ListenerParams(window_t=0.05),
                                             cuda_device)
    with pytest.raises(ValueError, match="window == 2 hop"):
        dense_dft_kernel.dense_dft_halves_cuda(
            torch.zeros(2, 16000, device=cuda_device), odd)


def test_dense_dft_smem_fits_two_blocks_an_sm_at_the_default_config(
        cuda_device):
    """__launch_bounds__(256, 2): two blocks' shared memory, each with the
    1 KB the card reserves a block, fit an SM's 228 KB; a config the kernel
    cannot take fails at the launch."""
    consts = dense_dft_kernel.DenseDftConstants(ListenerParams(), cuda_device)
    assert 2 * (dense_dft_kernel.smem_bytes(consts) + 1024) <= 228 * 1024
    bad = dense_dft_kernel.DenseDftConstants(ListenerParams(n_mfcc=24),
                                             cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        dense_dft_kernel.dense_dft_combined_cuda(
            torch.zeros(2, 16000, device=cuda_device), bad)


@pytest.mark.parametrize("gain", [1.0, 1.5])
@pytest.mark.parametrize("n_samples", [16000, 16001])
def test_load_kernels_match_plain(cuda_device, gain, n_samples):
    """16001 samples: rows that are not 16-byte aligned take the scalar
    path."""
    rng = np.random.default_rng(7)
    audio = torch.tensor((0.3 * rng.standard_normal((37, n_samples)) + 0.05)
                         .astype(np.float32), device=cuda_device)
    bound = 2e-6 * (audio * gain).abs().sum(1, keepdim=True)
    for launch, plain, extra in (
            (load_kernel.load_rowsum_cuda, load_kernel.load_rowsum_plain, ()),
            (load_kernel.load_broadcast_cuda, load_kernel.load_broadcast_plain,
             (600,))):
        before = launch.launches
        got = launch(audio, gain, *extra)
        torch.cuda.synchronize()
        assert launch.launches == before + 1
        want = plain(audio, gain, *extra)
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert ((got - want).abs() <= bound).all()


def test_load_kernels_reject_what_they_cannot_take(cuda_device):
    for launch, extra in ((load_kernel.load_rowsum_cuda, ()),
                          (load_kernel.load_broadcast_cuda, (600,))):
        with pytest.raises(TypeError):
            launch(torch.zeros(2, 16000, dtype=torch.float64, device=cuda_device),
                   1.0, *extra)
        with pytest.raises(ValueError):
            launch(torch.zeros(2, 32000, device=cuda_device)[:, ::2], 1.0, *extra)
        with pytest.raises(ValueError, match="gain"):
            launch(torch.zeros(2, 16000, device=cuda_device), torch.ones(2),
                   *extra)
        assert launch(torch.zeros(0, 16000, device=cuda_device), 1.0,
                      *extra).shape[0] == 0


def test_dev_entry_points_run_their_kernels(cuda_device):
    """The three dev mains at a small batch: each variant's kernels launch
    and every checksum is finite."""
    counters = (dense_dft_kernel.dense_dft_combined_cuda,
                dense_dft_kernel.dense_dft_halves_cuda,
                load_kernel.load_rowsum_cuda, load_kernel.load_broadcast_cuda)
    for fn in counters:
        fn.launches = 0
    rates = pallas_experiments.main(["--batch", "64", "--iters", "2",
                                     "--repeats", "1"])
    assert set(rates) == {"combined", "reshape", "bf16mat", "fft", "xla"}
    rates.update(r3_experiments.main(["--batch", "64", "--iters", "2",
                                      "--outer", "1"]))
    rates.update({f"r4 {k}": v for k, v in r4_mxu_stage1.main(
        ["--batch", "64", "--iters", "2"]).items()})
    assert all(r > 0 for r in rates.values())
    assert all(fn.launches > 0 for fn in counters)


# the CT split kernel (csrc/ct_frontend.cu): n2 = 8 (the default config, the
# butterfly), n2 = 6 with deltas (one tile a window, and 96 frames a window:
# tiles led by a halo row), n2 = 10 (bm 32 without the per-piece mel)
CT_CONFIGS = {
    "n2=8": {},
    "n2=6_deltas": {"n_fft": 768, "window_t": 0.048, "use_delta": True},
    "n2=6_hop160_deltas": {"n_fft": 768, "window_t": 0.048, "hop_t": 0.01,
                           "use_delta": True},
    "n2=10": {"n_fft": 1280, "window_t": 0.08, "hop_t": 0.04},
}


def _ct_audio(audio_dtype, batch=13):
    clips, _ = _clips()
    rows = clips[np.arange(batch) % 8].astype(np.float32) / 32768.0
    audio = rows * np.linspace(0.3, 1.5, batch, dtype=np.float32)[:, None]
    if audio_dtype == "int16":
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    return audio


@pytest.mark.parametrize("variant", sorted(ct_kernel.VARIANTS))
@pytest.mark.parametrize("name", sorted(CT_CONFIGS))
@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
@pytest.mark.parametrize("time_major", [False, True])
def test_ct_kernel_matches_plain(cuda_device, variant, name, audio_dtype,
                                 time_major):
    """B = 13: a ragged last block of windows; the split forced where route
    ct takes the mixed-radix FFT."""
    p = ListenerParams(**CT_CONFIGS[name])
    paired, per_piece, _ = ct_kernel.VARIANTS[variant]
    audio = torch.tensor(_ct_audio(audio_dtype), device=cuda_device)
    consts = ct_kernel.CtConstants(p, "mfcc", cuda_device)
    gain = torch.full((1,), 0.8, dtype=torch.float32, device=cuda_device)
    before = ct_kernel.counters[variant].launches
    got = ct_kernel.ct_frontend(audio, gain, consts, p, paired, per_piece,
                                time_major, _split=True)
    torch.cuda.synchronize()
    assert ct_kernel.counters[variant].launches == before + 1
    want = ct_kernel.ct_frontend_plain(audio, 0.8, consts, p, paired,
                                       per_piece, time_major)
    shape = (p.n_features, 13) if time_major else (13, p.n_features)
    assert got.shape == shape + (p.feature_size,)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


def test_ct_kernel_bark_bf16(cuda_device):
    """bf16 out and the bark filterbank, the split forced."""
    p = ListenerParams(n_fft=768, window_t=0.048, use_delta=True)
    consts = ct_kernel.CtConstants(p, "bark", cuda_device)
    audio = torch.tensor(_ct_audio("float32"), device=cuda_device)
    got = ct_kernel.ct_frontend(audio, None, consts, p,
                                out_dtype=torch.bfloat16, _split=True)
    want = ct_kernel.ct_frontend_plain(audio, None, consts, p,
                                       out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=1e-3 + 2.0 ** -7, atol=2e-3)


def test_ct_kernel_where_the_power_rows_fit_no_block(cuda_device):
    """n_fft = window = 3072 (n2 = 24): a block's 1537-float power rows fit
    in no shared memory, so the split's (F, F) and (T, F) launches raise
    ValueError; the per-piece-mel instantiations keep no power row and match
    the plain version; route ct of MfccFrontend runs the mixed-radix FFT."""
    p = ListenerParams(n_fft=3072, window_t=0.192, hop_t=0.016)
    consts = ct_kernel.CtConstants(p, "mfcc", cuda_device)
    audio = torch.tensor(_ct_audio("int16"), device=cuda_device)
    gain = torch.full((1,), 0.8, dtype=torch.float32, device=cuda_device)
    for variant, (paired, per_piece, _) in ct_kernel.VARIANTS.items():
        if not per_piece:
            with pytest.raises(ValueError, match="shared memory"):
                ct_kernel.ct_frontend_cuda(audio, gain, consts, p, paired,
                                           _split=True)
            continue
        got = ct_kernel.ct_frontend_cuda(audio, gain, consts, p, paired, True)
        want = ct_kernel.ct_frontend_plain(audio, 0.8, consts, p, paired, True)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)
    fe = MfccFrontend(p, "mfcc", cuda_device)
    assert fe.route == "ct" and fe.consts.body == "register"
    before = ct_kernel.MIXED.launches
    got = fe(audio, 0.8)
    assert ct_kernel.MIXED.launches == before + 1
    torch.testing.assert_close(got, fe.plain(audio, 0.8), rtol=1e-3, atol=2e-3)


def test_ct_kernel_rejects_what_it_cannot_take(cuda_device):
    p = ListenerParams(n_fft=768, window_t=0.048)
    consts = ct_kernel.CtConstants(p, "mfcc", cuda_device)
    one = torch.ones(1, device=cuda_device)
    with pytest.raises(TypeError):
        ct_kernel.ct_frontend_cuda(
            torch.zeros(2, 16000, dtype=torch.float64, device=cuda_device),
            one, consts, p)
    with pytest.raises(ValueError):
        ct_kernel.ct_frontend_cuda(
            torch.zeros(2, 32000, device=cuda_device)[:, ::2], one, consts, p)
    with pytest.raises(ValueError, match="n2 even"):
        ct_kernel.ct_frontend_cuda(torch.zeros(2, 16000, device=cuda_device),
                                   one, consts, ListenerParams(window_t=0.05))
    assert ct_kernel.ct_frontend_cuda(
        torch.zeros(0, 16000, device=cuda_device), one, consts,
        p).shape == (0, 30, 20)


# route ct's mixed-radix FFT: (audio dtype, out dtype, time_major, deltas,
# hop_t), each at every n_fft it takes
MIXED_CASES = {
    "f32->f32": ("float32", torch.float32, False, False, 0.032),
    "int16->bf16 time-major deltas": ("int16", torch.bfloat16, True, True,
                                      0.032),
    "int16->f32 deltas hop 256": ("int16", torch.float32, False, True, 0.016),
    "f32->bf16 time-major odd hop 481": ("float32", torch.bfloat16, True,
                                         False, 481 / 16000),
}


def _check_mixed(device, n_fft, case, batch):
    audio_dtype, out_dtype, time_major, delta, hop_t = MIXED_CASES[case]
    p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000, hop_t=hop_t,
                       use_delta=delta)
    consts = ct_kernel.CtConstants(p, "mfcc", device)
    assert consts.body == "register"
    audio = torch.tensor(_ct_audio(audio_dtype, batch), device=device)
    gain = torch.full((1,), 0.8, dtype=torch.float32, device=device)
    before = (ct_kernel.MIXED.launches,
              ct_kernel.counters["ct_frontend"].launches)
    got = ct_kernel.ct_frontend(audio, gain, consts, p, time_major=time_major,
                                out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (ct_kernel.MIXED.launches,
            ct_kernel.counters["ct_frontend"].launches) == (before[0] + 1,
                                                            before[1])
    want = ct_kernel.ct_frontend_plain(audio, 0.8, consts, p,
                                       time_major=time_major,
                                       out_dtype=out_dtype)
    shape = (p.n_features, batch) if time_major else (batch, p.n_features)
    assert got.shape == shape + (p.feature_size,) and got.dtype == out_dtype
    assert torch.isfinite(got.float()).all()
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3 + bf16,
                               atol=2e-3)


@pytest.mark.parametrize("batch", [1, 13])
@pytest.mark.parametrize("case", sorted(MIXED_CASES))
@pytest.mark.parametrize("n_fft", sorted(fft_plan.MIXED_PLANS))
def test_mixed_fft_matches_plain(cuda_device, n_fft, case, batch):
    """Every n_fft the mixed-radix FFT takes, f32 and int16 in, f32 and bf16
    out, batch- and time-major, with deltas, at hops 512, 256 and 481 (odd
    frame starts: scalar loads), one window and a ragged 13."""
    _check_mixed(cuda_device, n_fft, case, batch)


@pytest.mark.parametrize("n_fft", [768, 1536, 2816, 3840])
def test_mixed_fft_matches_plain_at_the_serving_batch(cuda_device, n_fft):
    _check_mixed(cuda_device, n_fft, "f32->f32", 8192)


@pytest.mark.parametrize("n_fft", [2816, 3840])
def test_mixed_fft_runs_what_the_split_refused(cuda_device, n_fft):
    """n_fft 2816 and 3840: the split's (F, F) launch refuses (its power rows
    fit no block); route ct of MfccFrontend and the scorer's frontend run
    the mixed-radix FFT, bark and bf16 out too."""
    p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000)
    audio = torch.tensor(_ct_audio("int16"), device=cuda_device)
    consts = ct_kernel.CtConstants(p, "bark", cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        ct_kernel.ct_frontend_cuda(audio, torch.ones(1, device=cuda_device),
                                   consts, p, _split=True)
    fe = MfccFrontend(p, "bark", cuda_device, out_dtype=torch.bfloat16)
    before = ct_kernel.MIXED.launches
    got = fe(audio, 0.8)
    assert ct_kernel.MIXED.launches == before + 1
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), fe.plain(audio, 0.8).float(),
                               rtol=1e-3 + 2.0 ** -7, atol=2e-3)


def test_mixed_fft_and_the_forced_split_agree(cuda_device):
    """n_fft 768: `_split=True` launches the split, the default the
    mixed-radix FFT; the two compute one function."""
    p = ListenerParams(n_fft=768, window_t=0.048, use_delta=True)
    consts = ct_kernel.CtConstants(p, "mfcc", cuda_device)
    audio = torch.tensor(_ct_audio("float32", 37), device=cuda_device)
    gain = torch.full((1,), 1.2, dtype=torch.float32, device=cuda_device)
    counts = (ct_kernel.MIXED.launches,
              ct_kernel.counters["ct_frontend"].launches)
    new = ct_kernel.ct_frontend_cuda(audio, gain, consts, p)
    old = ct_kernel.ct_frontend_cuda(audio, gain, consts, p, _split=True)
    assert (ct_kernel.MIXED.launches,
            ct_kernel.counters["ct_frontend"].launches) == (counts[0] + 1,
                                                            counts[1] + 1)
    torch.testing.assert_close(new, old, rtol=1e-3, atol=2e-3)


# route ct above n_fft 4096: the wide register FFT from the config, and the
# CT split's (F, T) instantiation ("split-dup") through per_piece_mel=True;
# (audio dtype, out dtype, time_major, deltas)
SPLIT_DUP_CASES = {
    "f32->f32": ("float32", torch.float32, False, False),
    "int16->bf16 time-major deltas": ("int16", torch.bfloat16, True, True),
    "int16->f32 deltas": ("int16", torch.float32, False, True),
    "f32->bf16 time-major": ("float32", torch.bfloat16, True, False),
}


@pytest.mark.parametrize("case", sorted(SPLIT_DUP_CASES))
@pytest.mark.parametrize("n_fft", [4352, 10240, 15872])
def test_split_dup_body_matches_plain(cuda_device, n_fft, case):
    """n_fft = window 4352 (23 frames), 10240 (12) and 15872 (1): route ct
    takes the wide FFT from the config; per_piece_mel=True launches the
    split's (F, T) instantiation, which holds to ct_frontend_plain, its
    launch counted apart from the (F, F) one's and the register FFTs'."""
    audio_dtype, out_dtype, time_major, delta = SPLIT_DUP_CASES[case]
    p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000, use_delta=delta)
    consts = ct_kernel.CtConstants(p, "mfcc", cuda_device)
    assert consts.body == "wide"
    audio = torch.tensor(_ct_audio(audio_dtype), device=cuda_device)
    gain = torch.full((1,), 0.8, dtype=torch.float32, device=cuda_device)
    watched = (ct_kernel.counters["ct_frontend_dup"],
               ct_kernel.counters["ct_frontend"], ct_kernel.MIXED,
               ct_kernel.WIDE)
    before = [c.launches for c in watched]
    got = ct_kernel.ct_frontend(audio, gain, consts, p, per_piece_mel=True,
                                time_major=time_major, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert [c.launches for c in watched] == [before[0] + 1] + before[1:]
    want = ct_kernel.ct_frontend_plain(audio, 0.8, consts, p,
                                       per_piece_mel=True,
                                       time_major=time_major,
                                       out_dtype=out_dtype)
    shape = (p.n_features, 13) if time_major else (13, p.n_features)
    assert got.shape == shape + (p.feature_size,) and got.dtype == out_dtype
    assert torch.isfinite(got.float()).all()
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3 + bf16,
                               atol=2e-3)
    fe = MfccFrontend(p, "mfcc", cuda_device, out_dtype=out_dtype)
    assert fe.route == "ct" and fe.body == "wide"


@pytest.mark.parametrize("case", sorted(SPLIT_DUP_CASES))
@pytest.mark.parametrize("n_fft", sorted(fft_plan.WIDE_PLANS))
def test_wide_body_matches_plain(cuda_device, n_fft, case):
    """Every n_fft the wide FFT takes (4352 .. 15872, a frame over two or
    four warps): route ct takes it from the config, its launch counted in
    ct_kernel.WIDE alone, and it holds to ct_frontend_plain."""
    audio_dtype, out_dtype, time_major, delta = SPLIT_DUP_CASES[case]
    p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000, use_delta=delta)
    fe = MfccFrontend(p, "mfcc", cuda_device, out_dtype=out_dtype)
    assert (fe.route, fe.body, fe.path) == ("ct", "wide", "cuda-ct(wide)")
    audio = torch.tensor(_ct_audio(audio_dtype), device=cuda_device)
    watched = (ct_kernel.WIDE, ct_kernel.MIXED,
               *ct_kernel.counters.values())
    before = [c.launches for c in watched]
    got = ct_kernel.ct_frontend(audio, 0.8, fe.consts, p,
                                time_major=time_major, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert [c.launches for c in watched] == [before[0] + 1] + before[1:]
    want = ct_kernel.ct_frontend_plain(audio, 0.8, fe.consts, p,
                                       time_major=time_major,
                                       out_dtype=out_dtype)
    shape = (p.n_features, 13) if time_major else (13, p.n_features)
    assert got.shape == shape + (p.feature_size,) and got.dtype == out_dtype
    assert torch.isfinite(got.float()).all()
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3 + bf16,
                               atol=2e-3)


@pytest.mark.parametrize("n_fft", [4352, 7936, 8448, 15872])
def test_wide_body_matches_plain_at_the_serving_batch(cuda_device, n_fft):
    """B = 8192 f32: two frames a block of 64 lanes (4352, 7936) and one of
    128 (8448, 15872)."""
    p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000)
    consts = ct_kernel.CtConstants(p, "mfcc", cuda_device)
    assert consts.body == "wide"
    audio = torch.tensor(_ct_audio("float32", 8192), device=cuda_device)
    got = ct_kernel.ct_frontend(audio, 1.0, consts, p)
    want = ct_kernel.ct_frontend_plain(audio, 1.0, consts, p)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


# route fft's wide body (csrc/mfcc_wide_frontend.cu): n_fft = window = 8192
# (16 frames, two frames a block of 64 lanes) and 16384 at window 12800 (7
# frames, one frame of 128 lanes, zero-padded)
FFT_WIDE_CONFIGS = {8192: 0.512, 16384: 0.8}  # n_fft: window_t
FFT_WIDE_CASES = {  # name: (audio dtype, out dtype, deltas)
    "f32->f32": ("float32", torch.float32, False),
    "int16->bf16 deltas": ("int16", torch.bfloat16, True),
    "int16->f32 deltas": ("int16", torch.float32, True),
    "f32->bf16": ("float32", torch.bfloat16, False),
}


def _check_fft_wide(device, p, audio_dtype, out_dtype, batch, feature_type="mfcc"):
    """Route fft's wide body at config `p` on `batch` windows: taken from
    the config, its launch counted in frontend_kernel.WIDE alone, held to
    the plain chain."""
    fe = MfccFrontend(p, feature_type, device, out_dtype=out_dtype)
    assert (fe.route, fe.body, fe.path) == ("fft", "wide", "cuda-mfcc(wide)")
    audio = torch.tensor(_ct_audio(audio_dtype, batch), device=device)
    watched = (frontend_kernel.WIDE, frontend_kernel.RADIX2,
               frontend_kernel.mfcc_frontend_cuda)
    before = [c.launches for c in watched]
    got = fe(audio, 0.8)
    torch.cuda.synchronize()
    assert [c.launches for c in watched] == [before[0] + 1] + before[1:]
    assert got.shape == (batch, p.n_features, p.feature_size)
    assert got.dtype == out_dtype and torch.isfinite(got.float()).all()
    want = fe.plain(audio, 0.8).to(out_dtype)
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3 + bf16,
                               atol=2e-3)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("case", sorted(FFT_WIDE_CASES))
@pytest.mark.parametrize("n_fft", sorted(FFT_WIDE_CONFIGS))
def test_fft_wide_body_matches_plain(cuda_device, n_fft, case, batch):
    audio_dtype, out_dtype, delta = FFT_WIDE_CASES[case]
    p = ListenerParams(n_fft=n_fft, window_t=FFT_WIDE_CONFIGS[n_fft],
                       use_delta=delta)
    _check_fft_wide(cuda_device, p, audio_dtype, out_dtype, batch)


@pytest.mark.parametrize("n_fft", sorted(FFT_WIDE_CONFIGS))
def test_fft_wide_body_matches_plain_at_the_serving_batch(cuda_device, n_fft):
    """B = 8192 f32, as chip_smoke.py times it."""
    p = ListenerParams(n_fft=n_fft, window_t=FFT_WIDE_CONFIGS[n_fft])
    _check_fft_wide(cuda_device, p, "float32", torch.float32, 8192)


@pytest.mark.parametrize("kw,feature_type", [
    ({"n_fft": 8192, "window_t": 0.375}, "bark"),  # window 6000
    ({"n_fft": 8192}, "mfcc"),  # window 1024, 30 frames
    ({"n_fft": 16384, "use_delta": True}, "mfcc"),
])
@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_fft_wide_body_zero_pads_a_shorter_window(cuda_device, kw,
                                                  feature_type, audio_dtype):
    """A window shorter than n_fft: its lanes' last pairs take the guarded
    loads, past the window zeros, as np.fft.rfft(frame, n=n_fft) pads."""
    p = ListenerParams(**kw)
    assert p.window_samples < p.n_fft
    _check_fft_wide(cuda_device, p, audio_dtype, torch.float32, 13,
                    feature_type)


@pytest.mark.parametrize("n_fft", sorted(FFT_WIDE_CONFIGS))
def test_fft_wide_and_radix2_bodies_agree(cuda_device, n_fft):
    """The A/B chip_smoke.py times: both bodies within the feature bound of
    each other, each counted to its own launch count."""
    p = ListenerParams(n_fft=n_fft, window_t=FFT_WIDE_CONFIGS[n_fft])
    audio = torch.tensor(_ct_audio("float32", 16), device=cuda_device)
    consts = frontend_kernel.KernelConstants(p, "mfcc", cuda_device)
    assert consts.body == "wide"
    gain = torch.full((1,), 1.2, dtype=torch.float32, device=cuda_device)
    before = (frontend_kernel.WIDE.launches, frontend_kernel.RADIX2.launches)
    new = frontend_kernel.mfcc_frontend_cuda(audio, gain, consts, p)
    old = frontend_kernel.mfcc_frontend_cuda(audio, gain, consts, p,
                                             _radix2=True)
    torch.cuda.synchronize()
    assert (frontend_kernel.WIDE.launches,
            frontend_kernel.RADIX2.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(new, old, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_coeffs", [300, 512, 600])
def test_split_dup_takes_many_coefficients(cuda_device, n_coeffs, audio_dtype,
                                           out_dtype):
    """n_fft = window = 4352 with n_filt = n_mfcc = 300 (blocks of 64 rows)
    and 512 (32 rows): more coefficients than one residue's T holds, so
    they take the idle T, ring and squares space; 600 (32 rows) outnumber
    that and take a region of their own.  Route ct takes the wide FFT in
    log-mel mode with the cepstrum kernel from the config
    (`test_many_coefficients_take_the_cepstrum_kernel`); split-dup, their
    A/B baseline (`per_piece_mel=True`), holds to ct_frontend_plain."""
    p = ListenerParams(n_fft=4352, window_t=0.272, n_filt=n_coeffs,
                       n_mfcc=n_coeffs)
    assert ct_kernel.split_rows(p, per_piece_mel=True) == (
        64 if n_coeffs == 300 else 32)
    grown = (ct_kernel.split_smem_bytes(32, 4352, n_coeffs, n_coeffs, True)
             - ct_kernel.split_smem_bytes(32, 4352, n_coeffs, 1, True))
    assert grown == (4 * 32 * n_coeffs if n_coeffs == 600 else 0)
    fe = MfccFrontend(p, "mfcc", cuda_device, out_dtype=out_dtype)
    assert (fe.route, fe.body, fe.cepstrum) == ("ct", "wide", True)
    audio = torch.tensor(_ct_audio(audio_dtype), device=cuda_device)
    before = ct_kernel.counters["ct_frontend_dup"].launches
    got = ct_kernel.ct_frontend(audio, 0.8, fe.consts, p, per_piece_mel=True,
                                out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ct_kernel.counters["ct_frontend_dup"].launches == before + 1
    want = ct_kernel.ct_frontend_plain(audio, 0.8, fe.consts, p,
                                       per_piece_mel=True,
                                       out_dtype=out_dtype)
    assert got.shape == (13, p.n_features, n_coeffs) and got.dtype == out_dtype
    assert torch.isfinite(got.float()).all()
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3 + bf16,
                               atol=2e-3)

def test_fft_kernel_takes_a_window_longer_than_n_fft(cuda_device):
    """window 1200 > n_fft 1024: the kernel reads a frame's first 1024
    samples, as the plain chain's DFT matrices do."""
    p = ListenerParams(window_t=0.075)
    fe = MfccFrontend(p, "mfcc", cuda_device)
    assert fe.route == "fft"
    audio = torch.tensor(_ct_audio("int16"), device=cuda_device)
    got = fe(audio, 0.8)
    torch.testing.assert_close(got, fe.plain(audio, 0.8), rtol=1e-3, atol=2e-3)


def test_dense_kernel_applies_a_gain_and_a_first_frame(cuda_device):
    """hop 480: 32 frames framed, 31 kept; gain 1.3 as g^2 on the power."""
    p = ListenerParams(hop_t=0.03)
    consts = dense_dft_kernel.DenseDftConstants(p, cuda_device)
    audio = torch.tensor(_ct_audio("float32"), device=cuda_device)
    gain = torch.full((1,), 1.3, dtype=torch.float32, device=cuda_device)
    first = dense_dft_kernel.n_frames_of(p, 16000) - p.n_features
    assert first == 1
    for variant in ("combined", "halves"):
        q = p if variant == "combined" else ListenerParams(window_t=0.06,
                                                           hop_t=0.03)
        c = consts if variant == "combined" else \
            dense_dft_kernel.DenseDftConstants(q, cuda_device)
        got = getattr(dense_dft_kernel, f"dense_dft_{variant}_cuda")(
            audio, c, gain, first)
        want = getattr(dense_dft_kernel, f"dense_dft_{variant}_plain")(
            audio, c, gain, first)
        assert got.shape == (13, dense_dft_kernel.n_frames_of(q, 16000) - 1,
                             q.n_mfcc)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)
    # the scorer's frontend at this config is the reference of that contract
    torch.testing.assert_close(
        dense_dft_kernel.dense_dft_combined_cuda(audio, consts, gain, first),
        MfccFrontend(p, "mfcc", cuda_device).plain(audio, 1.3),
        rtol=1e-3, atol=2e-3)


def test_ct_dev_entry_points_run_their_kernels(cuda_device):
    """The three CT dev mains at a small batch: each instantiation they
    name launches, and every checksum is finite."""
    for c in ct_kernel.counters.values():
        c.launches = 0
    rates = r3_frontend_variants.main(["--batch", "64", "--iters", "2"])
    assert set(rates) == {"production", "concat", "dup"}
    assert set(r3_stage2.main(["--batch", "64", "--iters", "2"])) == {
        "perres", "paired", "ppmel"}
    assert set(r3_widecell.main(["--batch", "64", "--iters", "2"])) == {
        "prod", "widecell"}
    assert all(c.launches > 0 for c in ct_kernel.counters.values())


@pytest.mark.parametrize("kw,route,counter", [
    ({"n_fft": 768, "window_t": 0.048}, "cuda-ct", ct_kernel.MIXED),
    ({"n_fft": 4352, "window_t": 0.272}, "cuda-ct(wide)", ct_kernel.WIDE),
    ({"window_t": 0.075}, "cuda-mfcc", frontend_kernel.mfcc_frontend_cuda),
    ({"n_fft": 8192}, "cuda-mfcc(wide)", frontend_kernel.WIDE),
    ({"n_fft": 16384, "window_t": 0.8}, "cuda-mfcc(wide)",
     frontend_kernel.WIDE),
    ({"n_fft": 400, "window_t": 0.025}, "torch(xla-route)", None),
])
def test_scorer_route_of_each_config_class(cuda_device, tmp_path, kw, route,
                                           counter):
    """The GRU checkpoint with its params set to a config of each class:
    the route the scorer records, its frontend kernel's launch, and the
    scores of the same scorer on the CPU."""
    import json

    data = dict(np.load(GRU_CKPT))
    meta = json.loads(bytes(data["__meta__"]))
    meta["params"].update(kw)
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    path = str(tmp_path / "gru.npz")
    np.savez(path, **data)
    clips, _ = _clips()
    scorer = make_batch_scorer(path, cuda_device)
    assert scorer.paths == {"frontend": route, "classifier": "cuda-gru"}
    watched = (ct_kernel.MIXED, ct_kernel.WIDE,
               ct_kernel.counters["ct_frontend"],
               ct_kernel.counters["ct_frontend_dup"],
               frontend_kernel.mfcc_frontend_cuda, frontend_kernel.WIDE,
               frontend_kernel.RADIX2)
    launches = {id(c): c.launches for c in watched}
    got = scorer(torch.tensor(clips, device=cuda_device), 0.9)
    torch.cuda.synchronize()
    for c in watched:
        assert c.launches == launches[id(c)] + (c is counter)
    want = make_batch_scorer(path, "cpu")(clips, 0.9)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)


# the stage cuts of both frontend kernels (ops/omission_kernel.py)
CUTS = [(k, s) for k, stages in omission_kernel.KERNELS.items() for s in stages]


@pytest.mark.parametrize("kernel,stage", CUTS, ids=[f"{k}-{s}" for k, s in CUTS])
@pytest.mark.parametrize("constant_block", [False, True],
                         ids=["streamed", "constant_block"])
@pytest.mark.parametrize("audio_dtype", ["float32", "int16"])
def test_truncated_kernel_matches_plain(cuda_device, kernel, stage,
                                        constant_block, audio_dtype):
    """B = 48: three batch tiles (so the constant block's i mod 16 shows),
    24 blocks of the CT kernel's two windows."""
    p = ListenerParams()
    consts = omission_kernel.TruncatedConstants(p, cuda_device)
    audio = torch.tensor(_ct_audio(audio_dtype, batch=48), device=cuda_device)
    gain = torch.full((1,), 1.3, dtype=torch.float32, device=cuda_device)
    counter = omission_kernel.counters[omission_kernel.counter_name(kernel,
                                                                    stage)]
    before = counter.launches
    got = omission_kernel.truncated(audio, gain, consts, p, stage, kernel,
                                    constant_block)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.shape == (48, 128) and torch.isfinite(got).all()
    want = omission_kernel.truncated_plain(audio, 1.3, p, stage,
                                           constant_block, consts.ct)
    atol, rtol = r3_omission.TOLERANCES[stage]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_truncated_kernels_reject_what_they_cannot_take(cuda_device):
    p = ListenerParams()
    consts = omission_kernel.TruncatedConstants(p, cuda_device)
    one = torch.ones(1, device=cuda_device)
    good = torch.zeros(16, 16000, device=cuda_device)
    for launch, c in ((omission_kernel.ct_truncated_cuda, consts.ct),
                      (omission_kernel.fft_truncated_cuda, consts.fft)):
        with pytest.raises(TypeError):
            launch(good.double(), one, c, p, "full")
        with pytest.raises(ValueError, match="multiple of 16"):
            launch(good[:8], one, c, p, "full")
        with pytest.raises(ValueError):
            launch(torch.zeros(16, 32000, device=cuda_device)[:, ::2], one, c,
                   p, "full")
        with pytest.raises(ValueError, match="unknown stage"):
            launch(good, one, c, p, "dct")
        with pytest.raises(ValueError, match="n2 = 8"):
            launch(good, one, c, ListenerParams(hop_t=0.016), "full")
        shifted = torch.zeros(16 * 16000 + 1, device=cuda_device)[1:]
        with pytest.raises(ValueError, match="aligned"):
            launch(shifted.view(16, 16000), one, c, p, "load")
        assert launch(good[:0], one, c, p, "full").shape == (0, 128)
    with pytest.raises(ValueError, match="butterfly"):
        omission_kernel.fft_truncated_cuda(good, one, consts.fft, p, "butterfly")


def test_omission_dev_entry_point_runs_every_cut(cuda_device):
    """dev.r3_omission at a small batch: every cut is held to the plain
    version, launches, and has a finite checksum."""
    for c in omission_kernel.counters.values():
        c.launches = 0
    rates = r3_omission.main(["--batch", "64", "--iters", "2", "--outer", "1"])
    assert len(rates) == 2 * len(CUTS) and all(r > 0 for r in rates.values())
    assert all(c.launches > 0 for c in omission_kernel.counters.values())


def _one_train_step(model_type, device, audio, labels):
    """One train step with --augment's pipeline (the frontend kernel on the
    card), adam, dropout 0, from init_model's seed-0 weights: (loss,
    variables, frontend launches)."""
    from tpu_speech_commands_torch.data.augment import make_audio_pipeline
    from tpu_speech_commands_torch.losses import make_loss_fn
    from tpu_speech_commands_torch.models import init_model
    from tpu_speech_commands_torch.ops.training_frontend import (
        select_training_frontend)
    from tpu_speech_commands_torch.optim import get_optimizer
    from tpu_speech_commands_torch.training.trainer import make_train_step

    model, _ = init_model(model_type, 5, seed=0, dropout_rate=0.0)
    model.to(device)
    frontend, kind = select_training_frontend(ListenerParams(), "mfcc",
                                              len(audio), device,
                                              verbose=False)
    assert kind == ("cuda-mfcc" if device.type == "cuda" else "torch")
    pipe = make_audio_pipeline(frontend, model_type, audio[labels == 0],
                               device=device)
    opt = get_optimizer("adam", 1e-3, decay_type=None, injectable=True,
                        params=model.parameters())
    step = make_train_step(model, make_loss_fn(5), opt, pipe, seed=3)
    before = frontend_kernel.mfcc_frontend_cuda.launches
    mask = torch.ones(len(audio), device=device)
    mask[-3:] = 0.0
    loss, _ = step(torch.tensor(audio, device=device),
                   torch.tensor(labels, dtype=torch.int64, device=device),
                   mask, 0)
    return (float(loss), model.variables(),
            frontend_kernel.mfcc_frontend_cuda.launches - before)


@pytest.mark.parametrize("model_type", ["simple_gru", "simple_cnn"])
def test_train_step_card_matches_cpu(cuda_device, model_type):
    """The same init, batch and augmentation draws: one step on the card
    (the frontend kernel, the plain module under autograd) and one on the
    CPU (the plain chain) give losses and parameters within 1e-4 (the
    frontend's f32 tolerance carried through one adam step)."""
    clips, names = _clips()
    rows = np.arange(32) % 8
    audio = clips[rows].astype(np.float32) / 32768.0
    classes = ["background", "left", "right", "up", "down"]
    labels = np.array([classes.index(names[r]) if names[r] in classes else 0
                       for r in rows])
    labels[::5] = 0  # a background share for the noise bank
    got_loss, got, launches = _one_train_step(model_type, cuda_device, audio,
                                              labels)
    want_loss, want, _ = _one_train_step(model_type, torch.device("cpu"),
                                         audio, labels)
    assert launches == 1 and np.isfinite(got_loss)
    assert abs(got_loss - want_loss) <= 1e-4
    for section in want:
        for group, tree in want[section].items():
            flat_got, flat_want = [], []

            def walk(a, b):
                if isinstance(b, dict):
                    for k in b:
                        walk(a[k], b[k])
                else:
                    flat_got.append(a)
                    flat_want.append(b)
            walk(got[section][group], tree)
            for a, b in zip(flat_got, flat_want):
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("ckpt", [GRU_CKPT, CNN_CKPTS["simple_cnn"],
                                  LSTM_CKPT])
def test_evaluate_accuracy_card_matches_cpu(cuda_device, ckpt):
    """evaluate_accuracy through the classifier kernel on the card and the
    plain module on the CPU, on the frontend kernel's features of the
    example clips, in a ragged last batch: the same accuracy (8/8) and
    confusion matrix; the classifier kernel's count rises."""
    from tpu_speech_commands_torch.data.dataset import Dataset
    from tpu_speech_commands_torch.evaluation import evaluate_accuracy
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.serving import make_classifier

    clips, names = _clips()
    results = []
    for device in (cuda_device, torch.device("cpu")):
        predictor = load_native(ckpt, device)
        fe = MfccFrontend(pr, "mfcc", device)
        feats = fe(torch.tensor(clips, device=device)).cpu().numpy()
        ds = Dataset(feats, np.array([predictor.classes.index(n)
                                      for n in names], np.int32))
        classifier, path = make_classifier(predictor.model,
                                           predictor.model_type)
        counter = {"cuda-gru": rnn_kernel.gru_layer_cuda,
                   "cuda-lstm": rnn_kernel.lstm_layer_cuda,
                   "cuda-cnn": cnn_kernel.cnn_classifier_cuda}.get(path)
        before = counter.launches if counter else 0
        results.append(evaluate_accuracy(classifier, ds, predictor.model_type,
                                         predictor.classes, batch_size=3,
                                         save_plot=False, verbose=False))
        if counter:
            assert counter.launches == before + 3
    (acc, conf), (cpu_acc, cpu_conf) = results
    assert acc == cpu_acc == 1.0
    np.testing.assert_array_equal(conf, cpu_conf)


STREAM_CKPTS = {"simple_gru": GRU_CKPT, "simple_lstm": LSTM_CKPT, **CNN_CKPTS}
# (kernel count, SIMT counts that must stay) of each classifier
STREAM_COUNTERS = {
    "simple_gru": (rnn_kernel.gru_layer_cuda,
                   (rnn_kernel.GRU_SIMT, rnn_kernel.LSTM_SIMT)),
    "simple_lstm": (rnn_kernel.lstm_layer_cuda,
                    (rnn_kernel.LSTM_SIMT, rnn_kernel.GRU_SIMT)),
    "simple_cnn": (cnn_kernel.cnn_classifier_cuda, (cnn_kernel.SIMT,)),
    "simple_cnn_lite": (cnn_kernel.cnn_classifier_cuda, (cnn_kernel.SIMT,)),
}


def _stream_tick(ckpt, device, chunk_size):
    """A fused stream tick for a checkpoint on `device`: (step, update,
    params)."""
    from tpu_speech_commands_torch.export.inference_loader import load_native
    from tpu_speech_commands_torch.frontend.dsp import Frontend
    from tpu_speech_commands_torch.serving import make_classifier
    from tpu_speech_commands_torch.streaming import (make_stream_step,
                                                     make_stream_update)

    predictor = load_native(ckpt, device)
    p = pr.replace()
    update = make_stream_update(Frontend(p, device=device), chunk_size)
    classifier, path = make_classifier(predictor.model, predictor.model_type)
    assert path == ("torch" if device.type == "cpu" else
                    {"simple_gru": "cuda-gru", "simple_lstm": "cuda-lstm"}
                    .get(predictor.model_type, "cuda-cnn"))
    return make_stream_step(update, classifier, predictor.model_type), p


@pytest.mark.parametrize("n_slots", [None, 1, 3, 16, 1000],
                         ids=["listener", "1", "3", "16", "1000"])
@pytest.mark.parametrize("model_type", sorted(STREAM_CKPTS))
def test_stream_tick_card_matches_cpu(cuda_device, model_type, n_slots):
    """The fused stream tick (ring update, frame features, classifier,
    softmax) on the card against the same tick on the CPU, over 7 ticks of
    800-sample chunks of the example clips, slots joining at ticks 0-3
    (reset_streams), so their fills differ: scores within the f32
    card-vs-CPU bound, the ring and fill equal, features within the f32
    feature bound; every tick launches the classifier kernel once, no SIMT
    kernel and no frontend kernel.  `listener` is the single-stream state
    (no stream axis)."""
    from tpu_speech_commands_torch.streaming import (init_stream_state,
                                                     reset_streams)

    clips, _ = _clips()
    n = 1 if n_slots is None else n_slots
    audio = (clips[np.arange(n) % 8].astype(np.float32) / 32768.0
             * np.linspace(0.5, 1.5, n, dtype=np.float32)[:, None])
    chunk_size, ticks = 800, 7
    joins = np.arange(n) % 4 if n_slots else np.zeros(1, int)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        step, p = _stream_tick(STREAM_CKPTS[model_type], device, chunk_size)
        state = init_stream_state(p, n_slots, device=device)
        kernel, simt = STREAM_COUNTERS[model_type]
        before = (kernel.launches, [c.launches for c in simt],
                  frontend_kernel.mfcc_frontend_cuda.launches)
        out = []
        for t in range(ticks):
            if n_slots:
                state = reset_streams(state, joins == t)
            local = np.clip(t - joins, 0, None)
            chunk = np.stack([audio[s, local[s] * chunk_size:
                                    (local[s] + 1) * chunk_size]
                              for s in range(n)])
            chunk = torch.tensor(chunk if n_slots else chunk[0], device=device)
            state, scores = step(state, chunk)
            out.append((scores.cpu(), {k: v.cpu() for k, v in state.items()}))
        if device.type == "cuda":
            assert kernel.launches == before[0] + ticks
            assert [c.launches for c in simt] == before[1]
            assert frontend_kernel.mfcc_frontend_cuda.launches == before[2]
        runs.append(out)
    if n > 1:
        assert len(set(runs[1][-1][1]["fill"].tolist())) > 1
    for t, ((got, g_state), (want, w_state)) in enumerate(zip(*runs)):
        assert torch.isfinite(got).all()
        assert got.shape == ((n, 5) if n_slots else (5,))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3,
                                   msg=f"tick {t} scores")
        assert torch.equal(g_state["audio"], w_state["audio"])
        assert torch.equal(g_state["fill"], w_state["fill"])
        torch.testing.assert_close(g_state["feats"], w_state["feats"],
                                   rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("model_type", sorted(STREAM_CKPTS))
def test_listener_card_matches_cpu(cuda_device, model_type):
    """`Listener.run_wav`'s loop over two example clips on the card and on
    the CPU: scores within the f32 card-vs-CPU bound, the same argmax and
    trigger events; the classifier kernel launches once a chunk."""
    import contextlib
    import io

    from tpu_speech_commands_torch.streaming import Listener

    clips, _ = _clips()
    pcm = np.concatenate([clips[4], clips[7]])  # right_1, up_2
    pcm = np.pad(pcm, (0, -len(pcm) % 1024))  # run_wav's zero-padded tail
    chunks = [pcm[i:i + 1024].tobytes() for i in range(0, len(pcm), 1024)]
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        listener = Listener(model_path=STREAM_CKPTS[model_type],
                            classes_path=os.path.join(
                                REPO, "configs", "direction_classes.txt"),
                            device=device)
        kernel, _ = STREAM_COUNTERS[model_type]
        before = kernel.launches
        scores, events = [], []
        with contextlib.redirect_stdout(io.StringIO()):
            for c, data in enumerate(chunks):
                s = listener.process_chunk(data)
                listener.handle_scores(s, on_activation=lambda i, c=c:
                                       events.append((c, i)))
                scores.append(s)
        if device.type == "cuda":
            assert kernel.launches == before + len(chunks)
        runs.append((np.stack(scores), events))
    (got, events), (want, cpu_events) = runs
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert events == cpu_events and [i for _, i in events] == [2, 3]


# the cepstrum kernel alone, (batch, frames, filters, coefficients): whole
# windows split over tiles unevenly, a window over two chunks of 128 rows,
# one frame a window, 600 coefficients over three column tiles of the kernel
# (five of its first design), one coefficient (the energy), the 240-filter
# scorer's 20 at 30 frames, 8 and 9 coefficients (either side of a
# multiple of 8: one column tile of 8 and one of 16)
CEP_SHAPES = [(1000, 23, 600, 600), (37, 150, 40, 13), (300, 7, 128, 128),
              (130, 1, 20, 20), (64, 30, 300, 1), (1000, 30, 240, 20),
              (333, 23, 64, 8), (333, 23, 64, 9)]


@pytest.mark.parametrize("design", ["wgmma", "simt"])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("deltas", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CEP_SHAPES)
def test_cepstrum_kernel_matches_plain(cuda_device, shape, out_dtype, deltas,
                                       time_major, design):
    """csrc/cepstrum_wgmma.cu, and its first design csrc/cepstrum.cu
    (`_simt=True`), against cepstrum_plan.cepstrum_plain on random log-mel
    rows, each launch counted in frontend_kernel.CEPSTRUM or
    CEPSTRUM_SIMT and never in the other."""
    batch, n_feat, n_filt, n_mfcc = shape
    rng = np.random.default_rng(sum(shape))
    logmel = torch.tensor(3.0 * rng.standard_normal(
        (batch, n_feat, n_filt + 1)), dtype=torch.float32, device=cuda_device)
    dct = torch.tensor(dct_t_matrix(n_filt), device=cuda_device)
    tables = cepstrum_plan.cep_tables(dct_t_matrix(n_filt), n_mfcc,
                                      cuda_device)
    simt = design == "simt"
    counts = (frontend_kernel.CEPSTRUM, frontend_kernel.CEPSTRUM_SIMT)
    before = [c.launches for c in counts]
    got = frontend_kernel.cepstrum_cuda(logmel, tables, n_mfcc, deltas,
                                        time_major, out_dtype, _simt=simt)
    torch.cuda.synchronize()
    assert [c.launches for c in counts] == [before[0] + (not simt),
                                            before[1] + simt]
    want = cepstrum_plan.cepstrum_plain(logmel, dct, n_mfcc, deltas,
                                        time_major, out_dtype)
    assert got.shape == want.shape and got.dtype == out_dtype
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3 + bf16,
                               atol=2e-3)


@pytest.mark.parametrize("n_mfcc", [40, 48, 64, 100, 150, 224, 225])
def test_cepstrum_kernel_takes_every_ring_depth(cuda_device, n_mfcc):
    """Column tiles of one block an SM at each ring depth, 8 stages (40
    columns) down to 3 (224, the widest tile), and 225 coefficients over two
    tiles of 120, with deltas, against the plain version."""
    n_filt = 240
    tile = cepstrum_plan.n_tile(n_mfcc)
    assert cepstrum_plan.blocks_per_sm(tile) == 1
    rng = np.random.default_rng(n_mfcc)
    logmel = torch.tensor(3.0 * rng.standard_normal((61, 23, n_filt + 1)),
                          dtype=torch.float32, device=cuda_device)
    tables = cepstrum_plan.cep_tables(dct_t_matrix(n_filt), n_mfcc,
                                      cuda_device)
    got = frontend_kernel.cepstrum_cuda(logmel, tables, n_mfcc, True)
    want = cepstrum_plan.cepstrum_plain(
        logmel, torch.tensor(dct_t_matrix(n_filt), device=cuda_device),
        n_mfcc, True)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_cepstrum_kernel_takes_rows_at_any_4_byte_offset(cuda_device, shift):
    """Rows that start 4, 8 or 12 bytes past a 16-byte boundary (a view into
    a larger buffer): the windows of the first row's slices begin before
    the rows and are zero-filled there; held to the plain version."""
    rng = np.random.default_rng(shift)
    batch, n_feat, n_filt, n_mfcc = 37, 23, 64, 20
    n = batch * n_feat * (n_filt + 1)
    buf = torch.tensor(3.0 * rng.standard_normal(n + shift),
                       dtype=torch.float32, device=cuda_device)
    logmel = buf[shift:].view(batch, n_feat, n_filt + 1)
    assert logmel.is_contiguous() and logmel.data_ptr() % 16 == 4 * shift
    tables = cepstrum_plan.cep_tables(dct_t_matrix(n_filt), n_mfcc,
                                      cuda_device)
    got = frontend_kernel.cepstrum_cuda(logmel, tables, n_mfcc, True)
    want = cepstrum_plan.cepstrum_plain(
        logmel, torch.tensor(dct_t_matrix(n_filt), device=cuda_device),
        n_mfcc, True)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)


def test_cepstrum_kernel_rejects_what_it_cannot_take(cuda_device):
    logmel = torch.zeros(2, 30, 21, device=cuda_device)
    tables = cepstrum_plan.cep_tables(dct_t_matrix(20), 20, cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        frontend_kernel.cepstrum_cuda(logmel.cpu(), tables, 20)
    with pytest.raises(ValueError, match="n_mfcc <= n_filt"):
        frontend_kernel.cepstrum_cuda(logmel, tables, 21)
    with pytest.raises(ValueError, match="contiguous f32"):
        frontend_kernel.cepstrum_cuda(logmel.transpose(0, 1), tables, 20)
    with pytest.raises(ValueError, match="row-major"):
        frontend_kernel.cepstrum_cuda(
            logmel, tables._replace(hi=tables.hi[:, :16]), 20)
    with pytest.raises(ValueError, match="row-major"):
        frontend_kernel.cepstrum_cuda(
            logmel, tables._replace(ext=tables.ext[:, :64]), 20, _simt=True)
    # another coefficient count's tables (another column tile)
    with pytest.raises(ValueError, match="row-major"):
        frontend_kernel.cepstrum_cuda(logmel, tables, 13)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(tables.hi.numel() + 1, device=cuda_device)
        frontend_kernel.cepstrum_cuda(
            logmel, tables._replace(hi=flat[1:].view(tables.hi.shape)), 20)


# (n_fft, n_filt, n_mfcc) of many filters and coefficients: each body in
# its mode from the config (+cep: log-mel mode and the cepstrum kernel)
CEP_CONFIGS = {
    (1024, 64, 20): ("fft", "register", True),
    (1024, 80, 40): ("fft", "register", True),
    (1024, 128, 20): ("fft", "register", True),
    (1024, 128, 128): ("fft", "register", True),
    (1024, 240, 20): ("fft", "register", True),
    (768, 230, 20): ("ct", "register", True),
    (4352, 300, 20): ("ct", "wide", True),
    (4352, 300, 300): ("ct", "wide", True),
    (4352, 600, 600): ("ct", "wide", True),
    (8192, 128, 128): ("fft", "wide", True),
}


@pytest.mark.parametrize("case", sorted(SPLIT_DUP_CASES))
@pytest.mark.parametrize("key", sorted(CEP_CONFIGS))
def test_many_filters_and_coefficients_match_plain(cuda_device, key, case):
    """The register and wide bodies at many filters and coefficients, in
    their mode from the config, in both input and output types, batch- and
    time-major (route ct), with and without deltas: the body's launch
    count rises once, the cepstrum kernel's once in its mode and never
    otherwise, no radix-2 or CT split launch; held to the plain version
    and the float64 features (`check_conditioned`)."""
    route, body, cepstrum = CEP_CONFIGS[key]
    audio_dtype, out_dtype, time_major, delta = SPLIT_DUP_CASES[case]
    p = cepstrum_ablation.config(*key).replace(use_delta=delta)
    fe = MfccFrontend(p, "mfcc", cuda_device, out_dtype=out_dtype)
    assert (fe.route, fe.body, fe.cepstrum) == (route, body, cepstrum)
    assert fe.path.endswith("+cep") == cepstrum
    counter = {("fft", "register"): frontend_kernel.mfcc_frontend_cuda,
               ("fft", "wide"): frontend_kernel.WIDE,
               ("ct", "register"): ct_kernel.MIXED,
               ("ct", "wide"): ct_kernel.WIDE}[route, body]
    watched = (counter, frontend_kernel.CEPSTRUM, frontend_kernel.RADIX2,
               frontend_kernel.CEPSTRUM_SIMT, *ct_kernel.counters.values())
    before = [c.launches for c in watched]
    audio = torch.tensor(_ct_audio(audio_dtype), device=cuda_device)
    if route == "ct":
        got = ct_kernel.ct_frontend(audio, 0.8, fe.consts, p,
                                    time_major=time_major,
                                    out_dtype=out_dtype)
        plain = ct_kernel.ct_frontend_plain(audio, 0.8, fe.consts, p)
    else:
        time_major = False
        got = fe(audio, 0.8)
        plain = fe.plain(audio, 0.8)
    torch.cuda.synchronize()
    assert [c.launches for c in watched] == [
        before[0] + 1, before[1] + cepstrum, *before[2:]]
    exact, slack = cepstrum_ablation.exact_features(p, audio, 0.8)
    if time_major:
        plain, exact, slack = (t.transpose(0, 1)
                               for t in (plain, exact, slack))
    assert got.dtype == out_dtype
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    cepstrum_ablation.check_conditioned(str(key), got, plain, exact, slack,
                                        2e-3, 1e-3 + bf16)


@pytest.mark.parametrize("key", [(1024, 20, 20), (1024, 80, 40),
                                 (1024, 128, 20), (4352, 80, 40),
                                 (8192, 128, 128), (768, 40, 40)])
def test_fused_trimmed_full_and_cepstrum_modes_agree(cuda_device, key):
    """The A/Bs of the slice compute one function: the fused epilogue on
    the trimmed DCT columns, on the whole table (`_full_dct=True`) and the
    log-mel mode with the cepstrum kernel (`_cepstrum=True`), within the
    feature bound of each other, the trimmed and the whole table bit for
    bit (the same products in the same order)."""
    p = cepstrum_ablation.config(*key).replace(use_delta=True)
    audio = torch.tensor(_ct_audio("float32", 37), device=cuda_device)
    gain = torch.full((1,), 1.1, dtype=torch.float32, device=cuda_device)
    if frontend_kernel.frontend_route(p) == "ct":
        consts = ct_kernel.CtConstants(p, "mfcc", cuda_device)
        launch = ct_kernel.ct_frontend_cuda
    else:
        consts = frontend_kernel.KernelConstants(p, "mfcc", cuda_device)
        launch = frontend_kernel.mfcc_frontend_cuda
    trimmed = launch(audio, gain, consts, p, _cepstrum=False)
    full = launch(audio, gain, consts, p, _cepstrum=False, _full_dct=True)
    before = frontend_kernel.CEPSTRUM.launches
    cep = launch(audio, gain, consts, p, _cepstrum=True)
    torch.cuda.synchronize()
    assert frontend_kernel.CEPSTRUM.launches == before + 1
    torch.testing.assert_close(trimmed, full, rtol=0, atol=0)
    torch.testing.assert_close(cep, trimmed, rtol=1e-3, atol=2e-3)



# (n_fft, n_filt, n_mfcc) of log-mel mode: route ct's wide body at 4352,
# route fft's register body at 1024 and wide body at 8192, route ct's
# mixed-radix body at 768
LOGMEL_CONFIGS = [(4352, 300, 300), (4352, 512, 512), (4352, 600, 600),
                  (1024, 240, 20), (1024, 64, 20), (8192, 128, 128),
                  (768, 230, 20)]


@pytest.mark.parametrize("tail", ["rows", "partial_sums"])
@pytest.mark.parametrize("key", LOGMEL_CONFIGS)
def test_logmel_tails_match_the_float64_rows(cuda_device, key, tail):
    """Log-mel mode alone (`fft_logmel_cuda`, `ct_kernel.ct_logmel_cuda`),
    its tail and its first tail (`_partial_sums=True`): the (B, T, n_filt +
    1) rows, at 37 windows (rows start at every shift from a 16-byte
    boundary), f32 and
    int16 in, held to the float64 rows within the feature bound plus the
    rounding slack, and so is the plain version (`check_conditioned`); the
    body's count and the tail's rise once, no cepstrum kernel; the two
    tails within 1e-5 of each other (the same powers, sums of terms >= 0
    grouped otherwise)."""
    p = cepstrum_ablation.config(*key)
    route = frontend_kernel.frontend_route(p)
    consts = (ct_kernel.CtConstants if route == "ct" else
              frontend_kernel.KernelConstants)(p, "mfcc", cuda_device)
    assert consts.cepstrum and consts.body in ("register", "wide")
    launch = (ct_kernel.ct_logmel_cuda if route == "ct" else
              frontend_kernel.fft_logmel_cuda)
    counter = {("fft", "register"): frontend_kernel.mfcc_frontend_cuda,
               ("fft", "wide"): frontend_kernel.WIDE,
               ("ct", "register"): ct_kernel.MIXED,
               ("ct", "wide"): ct_kernel.WIDE}[route, consts.body]
    mine, other = ((frontend_kernel.PARTIAL_SUMS, frontend_kernel.LOGMEL)
                   if tail == "partial_sums" else
                   (frontend_kernel.LOGMEL, frontend_kernel.PARTIAL_SUMS))
    watched = (counter, mine, other, frontend_kernel.CEPSTRUM)
    gain = torch.full((1,), 0.8, dtype=torch.float32, device=cuda_device)
    for audio_dtype in ("float32", "int16"):
        audio = torch.tensor(_ct_audio(audio_dtype, 37), device=cuda_device)
        before = [c.launches for c in watched]
        got = launch(audio, gain, consts, p,
                     _partial_sums=tail == "partial_sums")
        torch.cuda.synchronize()
        assert [c.launches for c in watched] == [
            before[0] + 1, before[1] + 1, before[2], before[3]]
        assert got.shape == (37, p.n_features, p.n_filt + 1)
        plain = cepstrum_plan.logmel_plain(Frontend(p, "mfcc", cuda_device),
                                           audio, 0.8)
        exact, slack = cepstrum_ablation.exact_logmel(p, audio, 0.8)
        cepstrum_ablation.check_conditioned(f"{key} {tail} {audio_dtype}",
                                            got, plain, exact, slack,
                                            2e-3, 1e-3)
        twin = launch(audio, gain, consts, p,
                      _partial_sums=tail != "partial_sums")
        torch.testing.assert_close(got, twin, rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", [(4352, 600, 600), (1024, 240, 20)])
def test_cepstrum_frontend_takes_either_tail(cuda_device, key):
    """The +cep frontend through its route's wrapper with either tail
    (`_partial_sums`): the same features within the feature bound, each
    held to the float64 features (`check_conditioned`); the tail's count
    rises, the cepstrum kernel's once each."""
    p = cepstrum_ablation.config(*key).replace(use_delta=True)
    audio = torch.tensor(_ct_audio("float32", 21), device=cuda_device)
    fe = MfccFrontend(p, "mfcc", cuda_device)
    assert fe.cepstrum
    gain = torch.ones(1, dtype=torch.float32, device=cuda_device)
    launch = (ct_kernel.ct_frontend_cuda if fe.route == "ct"
              else frontend_kernel.mfcc_frontend_cuda)
    exact, slack = cepstrum_ablation.exact_features(p, audio)
    plain = fe.plain(audio) if fe.route == "fft" else \
        ct_kernel.ct_frontend_plain(audio, None, fe.consts, p)
    outs = []
    for flag, counter in ((False, frontend_kernel.LOGMEL),
                          (True, frontend_kernel.PARTIAL_SUMS)):
        before = (counter.launches, frontend_kernel.CEPSTRUM.launches)
        outs.append(launch(audio, gain, fe.consts, p, _partial_sums=flag))
        torch.cuda.synchronize()
        assert (counter.launches, frontend_kernel.CEPSTRUM.launches) == (
            before[0] + 1, before[1] + 1)
        cepstrum_ablation.check_conditioned(f"{key} {flag}", outs[-1], plain,
                                            exact, slack, 2e-3, 1e-3)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_filt", [160, 240, 400])
def test_fast_math_many_filters_match_the_float64_features(cuda_device,
                                                           n_filt, out_dtype):
    """The fast_math kernel at 160, 240 and 400 filters (its log-mel mode
    and the cepstrum kernel, `dft_cepstrum`; where the fused block fits,
    also fused with the trimmed DCT, `_cepstrum=False`), f32 and int16 in,
    with deltas: its launch counts (the kernel's, log-mel mode's, the
    cepstrum kernel's) rise, and it and the plain fast_math chain are held
    to the float64 features of the bf16 frames and DFT matrix within the
    feature bound plus the rounding slack (`check_conditioned`)."""
    p = ListenerParams(n_filt=n_filt, use_delta=True)
    fe = MfccFrontend(p, "mfcc", cuda_device, out_dtype=out_dtype,
                      fast_math=True)
    assert fe.route == "fast_math" and fe.cepstrum
    assert fe.path == "cuda-fast_math+cep"
    bf16 = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    for audio_dtype in ("float32", "int16"):
        audio = torch.tensor(_ct_audio(audio_dtype, 37), device=cuda_device)
        exact, slack = cepstrum_ablation.exact_features(p, audio, 0.8,
                                                        fast_math=True)
        plain = fe.plain(audio, 0.8)
        watched = (frontend_kernel.dft_frontend_bf16_cuda,
                   frontend_kernel.DFT_LOGMEL, frontend_kernel.CEPSTRUM)
        before = [c.launches for c in watched]
        got = fe(audio, 0.8)
        torch.cuda.synchronize()
        assert [c.launches for c in watched] == [b + 1 for b in before]
        assert got.dtype == out_dtype
        cepstrum_ablation.check_conditioned(
            f"fast_math {n_filt} {audio_dtype}", got, plain, exact, slack,
            2e-3, 1e-3 + bf16)
        old_design = frontend_kernel.dft_frontend_bf16_cuda(
            audio, torch.full((1,), 0.8, dtype=torch.float32,
                              device=cuda_device),
            fe.consts, p, out_dtype, _shared_sums=True)
        cepstrum_ablation.check_conditioned(
            f"fast_math {n_filt} shared sums {audio_dtype}", old_design,
            plain, exact, slack, 2e-3, 1e-3 + bf16)
        if fe.consts.layouts[False].smem_bytes <= frontend_kernel.DFT_SMEM_MAX:
            fused = frontend_kernel.dft_frontend_bf16_cuda(
                audio, torch.full((1,), 0.8, dtype=torch.float32,
                                  device=cuda_device),
                fe.consts, p, out_dtype, _cepstrum=False)
            cepstrum_ablation.check_conditioned(
                f"fast_math {n_filt} fused {audio_dtype}", fused, plain,
                exact, slack, 2e-3, 1e-3 + bf16)


@pytest.mark.parametrize("feature_type", ["mfcc", "bark"])
@pytest.mark.parametrize("n_filt", [96, 128, 160, 240, 400, 512])
def test_fast_math_logmel_rows_match_the_float64_rows(cuda_device, n_filt,
                                                      feature_type):
    """The fast_math kernel's log-mel mode alone (`dft_logmel_cuda`: finished
    filters from the registers, 4 windows a block) and its first design
    (`_shared_sums=True`) on the same inputs, f32 and int16 audio at B 1,
    37 and 8192: each launch counted once in its own counter, every row
    finite, and each design and the plain fast_math rows held to the
    float64 rows of the bf16 frames and DFT matrix within the feature bound
    plus the rounding slack (`check_conditioned`); the two designs within
    that bound of each other."""
    p = ListenerParams(n_filt=n_filt)
    consts = frontend_kernel.DftConstants(p, feature_type, cuda_device)
    assert consts.layouts[True].wpb == 4 and not consts.layouts[True].shared_sums
    plain = Frontend(p, feature_type, cuda_device, fast_math=True)
    gain = torch.full((1,), 0.8, dtype=torch.float32, device=cuda_device)
    for batch in (1, 37, 8192):
        for audio_dtype in ("float32", "int16"):
            audio = torch.tensor(_ct_audio(audio_dtype, batch),
                                 device=cuda_device)
            exact, slack = cepstrum_ablation.exact_logmel(
                p, audio, 0.8, feature_type, fast_math=True)
            want = cepstrum_plan.logmel_plain(plain, audio, 0.8)
            rows = {}
            for flag, counter in ((False, frontend_kernel.DFT_LOGMEL),
                                  (True, frontend_kernel.DFT_SHARED_SUMS)):
                before = counter.launches
                rows[flag] = frontend_kernel.dft_logmel_cuda(
                    audio, gain, consts, p, _shared_sums=flag)
                torch.cuda.synchronize()
                assert counter.launches == before + 1
                assert torch.isfinite(rows[flag]).all()
                cepstrum_ablation.check_conditioned(
                    f"{feature_type} {n_filt} B {batch} {audio_dtype} "
                    f"shared_sums={flag}", rows[flag], want, exact, slack,
                    2e-3, 1e-3)
            bound = 2e-3 + 1e-3 * exact.abs() + slack
            assert ((rows[False] - rows[True]).abs() <= 2 * bound).all()
            del exact, slack, want, rows


def test_unservable_power_of_two_runs_the_plain_chain_on_the_card(
        cuda_device):
    """n_fft 32768: no body of the FFT kernel takes it, so the frontend
    built for the card takes route "torch" (the plain chain there), launches
    no frontend kernel, and matches the plain chain on the CPU within the
    f32 feature bound (chip_smoke.py drives a scorer there)."""
    p = ListenerParams(n_fft=32768)
    fe = MfccFrontend(p, "mfcc", cuda_device)
    assert (fe.route, fe.path, fe.consts) == ("torch", "torch(xla-route)",
                                              None)
    watched = (frontend_kernel.mfcc_frontend_cuda, frontend_kernel.RADIX2,
               frontend_kernel.WIDE)
    before = [c.launches for c in watched]
    audio = _ct_audio("float32", 64)
    got = fe(torch.tensor(audio, device=cuda_device))
    torch.cuda.synchronize()
    assert [c.launches for c in watched] == before
    want = MfccFrontend(p, "mfcc", "cpu")(torch.tensor(audio))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-3)
