"""The port's RNN models and GRU kernel wrapper against the JAX package.

Weights come from the JAX package's own init (flax `model.init` from a
PRNGKey) and cross over through `convert.torch_state_from_jax`; inputs are
numpy arrays made from a seed.  Tolerances:
- f32 logits vs `model.apply` and vs `make_fused_rnn_classifier`
  (interpret mode): rtol 1e-4 / atol 1e-5, the bound
  tests/test_pallas_rnn.py holds the fused kernel to;
- bf16 (bf16 matmul inputs, f32 accumulation and gates) vs the fused JAX
  kernel's bf16 mode: atol 5e-2, the bound tests/test_serving.py allows
  bf16 scores (rounding can flip at a bf16 boundary).

The CUDA GRU kernel against the plain loop on the card: test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech_commands.models import get_model as jax_get_model
from tpu_speech_commands.ops.pallas_rnn import make_fused_rnn_classifier
from tpu_speech_commands_torch.convert import torch_state_from_jax
from tpu_speech_commands_torch.models import get_model, score_fn
from tpu_speech_commands_torch.models.cnn import SimpleCNN, SimpleCNNLite
from tpu_speech_commands_torch.models.rnn import SimpleGRU, SimpleLSTM
from tpu_speech_commands_torch.ops import rnn_kernel
from tpu_speech_commands_torch.ops.rnn_kernel import GRUClassifier

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-2
T, D = 30, 20


def _jax_model(model_type, num_classes, num_layers, seed, shape=(T, D)):
    model = jax_get_model(model_type, num_classes, num_layers=num_layers)
    x = jnp.zeros((2,) + shape, jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, x,
                           train=False)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port_model(model_type, variables, num_classes, num_layers):
    model = get_model(model_type, num_classes, num_layers=num_layers,
                      feature_size=D)
    model.load_state_dict(torch_state_from_jax(variables, model_type))
    return model.eval()


def _features(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, T, D)).astype(np.float32)


CASES = [("simple_gru", 1), ("simple_gru", 2), ("simple_lstm", 1),
         ("simple_lstm", 2)]


@pytest.mark.parametrize("model_type,num_layers", CASES)
def test_plain_matches_jax_apply_and_fused(model_type, num_layers):
    jmodel, variables = _jax_model(model_type, 5, num_layers, seed=num_layers)
    x = _features(8, seed=42)
    want_apply = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                         train=False))
    fused = make_fused_rnn_classifier(
        variables, cell_type=model_type.split("_")[1], n_features=T,
        feature_size=D, batch_tile=4, interpret=True)
    want_fused = np.asarray(fused(jnp.asarray(x)))
    port = _port_model(model_type, variables, 5, num_layers)
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    assert got.shape == (8, 5)
    np.testing.assert_allclose(got, want_apply, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_fused, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_gru_bf16_matches_fused_bf16(num_layers):
    _, variables = _jax_model("simple_gru", 5, num_layers, seed=7)
    x = _features(8, seed=9)
    fused = make_fused_rnn_classifier(
        variables, cell_type="gru", n_features=T, feature_size=D,
        batch_tile=8, interpret=True, compute_dtype=jnp.bfloat16)
    want = np.asarray(fused(jnp.asarray(x)))
    port = _port_model("simple_gru", variables, 5, num_layers)
    got = GRUClassifier(port, torch.bfloat16)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_plain_loop(compute_dtype):
    _, variables = _jax_model("simple_gru", 4, 2, seed=3)
    port = _port_model("simple_gru", variables, 4, 2)
    x = torch.tensor(_features(6, seed=5))
    got = GRUClassifier(port, compute_dtype)(x)
    with torch.no_grad():
        want = port(x, compute_dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a trailing channel axis is squeezed, as the JAX kernel does
    torch.testing.assert_close(GRUClassifier(port, compute_dtype)(x[..., None]),
                               want, rtol=0, atol=0)


def test_gru_is_keras_not_torch_gru():
    """Linear candidate and reset_after: one step by hand."""
    torch.manual_seed(0)
    model = SimpleGRU(2, feature_size=3, recurrent_units=4)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.5)
    cell = model.backbone.gru_unit_0
    x = torch.randn(5, 3)
    h = torch.randn(5, 4)
    xz, xr, xh = (x @ cell.kernel + cell.bias_input).chunk(3, -1)
    hz, hr, hh = (h @ cell.recurrent_kernel + cell.bias_recurrent).chunk(3, -1)
    z, r = torch.sigmoid(xz + hz), torch.sigmoid(xr + hr)
    want = z * h + (1 - z) * (xh + r * hh)
    torch.testing.assert_close(cell(h, x), want, rtol=0, atol=0)


def test_state_dict_keeps_keras_names():
    keys = set(SimpleGRU(5, 20, 48, num_layers=2).state_dict())
    assert keys == {
        f"backbone.gru_unit_{i}.{f}" for i in range(2)
        for f in ("kernel", "recurrent_kernel", "bias_input", "bias_recurrent")
    } | {"score_predict.kernel", "score_predict.bias"}
    assert set(SimpleLSTM(5, 20, 48).state_dict()) == {
        "backbone.lstm_unit_0.kernel", "backbone.lstm_unit_0.recurrent_kernel",
        "backbone.lstm_unit_0.bias", "score_predict.kernel",
        "score_predict.bias"}


def test_convert_rejects_bad_trees():
    _, variables = _jax_model("simple_gru", 5, 1, seed=0)
    params = variables["params"]
    bad = {"params": {**params, "score_predict": {
        "kernel": np.zeros((47, 5), np.float32),
        "bias": np.zeros(5, np.float32)}}}
    with pytest.raises(ValueError, match="score_predict/kernel"):
        torch_state_from_jax(bad, "simple_gru")
    layer = dict(params["backbone"]["gru_unit_0"])
    layer["recurrent_kernel"] = np.zeros((48, 143), np.float32)
    bad = {"params": {**params, "backbone": {"gru_unit_0": layer}}}
    with pytest.raises(ValueError, match="recurrent_kernel"):
        torch_state_from_jax(bad, "simple_gru")
    with pytest.raises(ValueError, match="lstm_unit_"):
        torch_state_from_jax(variables, "simple_lstm")
    # a GRU tree is no CNN tree; a CNN tree converts (test_torch_cnn.py)
    with pytest.raises(ValueError, match="batch_stats"):
        torch_state_from_jax(variables, "simple_cnn")
    _, cnn_vars = _jax_model("simple_cnn", 5, 1, seed=0, shape=(30, 20, 1))
    assert "block1.bn.mean" in torch_state_from_jax(cnn_vars, "simple_cnn")


def test_factory_refuses_cnn_and_bad_layers():
    """CNNs build; a CNN with num_layers != 1 is refused, as are bad layer
    counts and unknown types."""
    assert isinstance(get_model("simple_cnn", 5), SimpleCNN)
    lite = get_model("simple_cnn_lite", 5, n_features=30, feature_size=40)
    assert isinstance(lite, SimpleCNNLite) and lite.separable
    assert lite.feature_dense.kernel.shape == (2 * 2 * 128, 128)
    with pytest.raises(ValueError, match="num_layers"):
        get_model("simple_cnn", 5, num_layers=2)
    with pytest.raises(ValueError):
        get_model("simple_gru", 5, num_layers=0)
    with pytest.raises(ValueError):
        get_model("wavenet", 5)
    logits = torch.tensor([[1.0, 2.0, 3.0]])
    torch.testing.assert_close(score_fn(logits).sum(-1), torch.ones(1))


def test_raw_wrapper_refuses_cpu_tensors():
    cell = SimpleGRU(5, 20, 48).backbone.gru_unit_0
    with pytest.raises(ValueError, match="CUDA tensor"):
        rnn_kernel.gru_layer_cuda(torch.zeros(2, T, D), cell.kernel,
                                  cell.recurrent_kernel, cell.bias_input,
                                  cell.bias_recurrent)
