"""The port's LSTM classifier (plain version of `csrc/lstm_classifier.cu`)
against the JAX package's fused RNN kernel, `make_fused_rnn_classifier(
cell_type='lstm')`, in interpret mode.

Weights come from the JAX package's own init or from the shipped
checkpoint; inputs are numpy arrays made from a seed or the frontend
features of the eight example clips.  Tolerances:
- f32 logits: rtol 1e-4 / atol 1e-5, the bound tests/test_pallas_rnn.py
  holds the fused kernel to;
- bf16 (bf16 matmul inputs, f32 accumulation, f32 cell and gate math):
  atol 5e-2, the bound tests/test_serving.py allows bf16 scores (rounding
  can flip at a bf16 boundary and grow over 30 steps).

The CUDA LSTM kernel against the plain loop on the card: test_torch_gpu.py.
"""
import glob
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech_commands.models import get_model as jax_get_model
from tpu_speech_commands.ops.pallas_rnn import make_fused_rnn_classifier
from tpu_speech_commands.training.checkpoints import load_checkpoint
from tpu_speech_commands_torch.convert import torch_state_from_jax
from tpu_speech_commands_torch.export.inference_loader import load_native
from tpu_speech_commands_torch.frontend import Frontend
from tpu_speech_commands_torch.models import get_model
from tpu_speech_commands_torch.models.rnn import SimpleGRU, SimpleLSTM
from tpu_speech_commands_torch.ops import rnn_kernel
from tpu_speech_commands_torch.ops.rnn_kernel import LSTMClassifier
from tpu_speech_commands_torch.params import ListenerParams, pr

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-2
T, D = 30, 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSTM_CKPT = os.path.join(REPO, "pretrained", "direction_simple_lstm.npz")


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """A checkpoint load writes its params into the port's own `pr`, which
    tests/conftest.py does not restore: snapshot and restore it here."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _jax_lstm(num_layers, seed):
    model = jax_get_model("simple_lstm", 5, num_layers=num_layers)
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           jnp.zeros((2, T, D), jnp.float32), train=False)
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_lstm(variables, num_layers):
    model = get_model("simple_lstm", 5, num_layers=num_layers, feature_size=D)
    model.load_state_dict(torch_state_from_jax(variables, "simple_lstm"))
    return model.eval()


def _features(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, T, D)).astype(np.float32)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_lstm_bf16_matches_fused_bf16(num_layers):
    variables = _jax_lstm(num_layers, seed=17)
    x = _features(8, seed=19)
    fused = make_fused_rnn_classifier(
        variables, cell_type="lstm", n_features=T, feature_size=D,
        batch_tile=8, interpret=True, compute_dtype=jnp.bfloat16)
    want = np.asarray(fused(jnp.asarray(x)))
    got = LSTMClassifier(_port_lstm(variables, num_layers),
                         torch.bfloat16)(torch.tensor(x)).numpy()
    assert got.shape == (8, 5)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)


def test_pretrained_lstm_on_clip_features_matches_fused():
    """direction_simple_lstm.npz through LSTMClassifier (CPU: the plain
    loop) and through the JAX kernel, on the frontend features of the eight
    example clips, f32."""
    clips = []
    for path in sorted(glob.glob(os.path.join(REPO, "example", "*.wav"))):
        with wave.open(path, "rb") as wf:
            pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        pcm = pcm[-16000:]
        clips.append(np.pad(pcm, (16000 - len(pcm), 0)))
    assert len(clips) == 8
    feats = Frontend(ListenerParams(), device="cpu")(
        torch.tensor(np.stack(clips)))
    variables, meta = load_checkpoint(LSTM_CKPT)
    assert meta["model_type"] == "simple_lstm"
    fused = make_fused_rnn_classifier(
        variables, cell_type="lstm", n_features=T, feature_size=D,
        batch_tile=8, interpret=True)
    want = np.asarray(fused(jnp.asarray(feats.numpy())))
    got = LSTMClassifier(load_native(LSTM_CKPT, "cpu").model)(feats).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_lstm_wrapper_on_cpu_is_the_plain_loop(compute_dtype):
    port = _port_lstm(_jax_lstm(2, seed=23), 2)
    x = torch.tensor(_features(6, seed=29))
    got = LSTMClassifier(port, compute_dtype)(x)
    with torch.no_grad():
        want = port(x, compute_dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a trailing channel axis is squeezed, as the JAX kernel does
    torch.testing.assert_close(
        LSTMClassifier(port, compute_dtype)(x[..., None]), want, rtol=0,
        atol=0)


def test_raw_lstm_wrapper_refuses_cpu_tensors():
    cell = SimpleLSTM(5, 20, 48).backbone.lstm_unit_0
    with pytest.raises(ValueError, match="CUDA tensor"):
        rnn_kernel.lstm_layer_cuda(torch.zeros(2, T, D), cell.kernel,
                                   cell.recurrent_kernel, cell.bias)


def test_lstm_classifier_refuses_other_models_and_dtypes():
    with pytest.raises(TypeError, match="SimpleLSTM"):
        LSTMClassifier(SimpleGRU(5, 20, 48))
    with pytest.raises(TypeError, match="compute_dtype"):
        LSTMClassifier(SimpleLSTM(5, 20, 48), torch.float16)
