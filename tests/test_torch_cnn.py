"""The port's CNN models, host lowering and CNN kernel plain versions against
the JAX package.

Weights are the two pretrained CNN checkpoints, or the JAX package's own
init (flax `model.init`) with the BatchNorm running statistics moved off
their init by three train-mode applies, so that folding bugs show.  Inputs
are numpy arrays made from a seed.  The JAX kernels run in interpret mode.
Shapes: 30 x 20 (the default MFCC features), 30 x 40 (`use_delta`: block 3
runs stride 2 over an even width, where SAME pads 0 low and 1 high) and
29 x 21 (odd dimensions: the VALID pools drop a row and a column).
Tolerances:
- f32: rtol 1e-4 / atol 1e-5, the bound tests/test_pallas_cnn.py holds the
  fused JAX kernels to against `model.apply`;
- bf16 (bf16 conv and dense inputs and weights, f32 sums and epilogues) vs
  the JAX kernels' bf16 mode: atol 5e-2, the bound tests/test_serving.py
  allows bf16 scores (a rounding of an activation can flip at a bf16
  boundary when two sums differ in the last f32 bit).

The CUDA kernels against these plain versions on the card: test_torch_gpu.py.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech_commands.models import get_model as jax_get_model
from tpu_speech_commands.models.cnn import _ConvBlock
from tpu_speech_commands.ops import pallas_classifier
from tpu_speech_commands.ops.pallas_cnn import fold_block1_params as jax_fold
from tpu_speech_commands.ops.pallas_cnn import make_fused_cnn_forward as jax_fused_forward
from tpu_speech_commands.ops.pallas_cnn import make_fused_conv_block1 as jax_block1
from tpu_speech_commands_torch.checkpoints import load_checkpoint
from tpu_speech_commands_torch.convert import torch_state_from_jax
from tpu_speech_commands_torch.models import get_model
from tpu_speech_commands_torch.models.cnn import SimpleCNN, same_pads
from tpu_speech_commands_torch.ops import (
    CNNClassifier,
    cnn_kernel,
    make_fused_cnn_forward,
    make_fused_conv_block1,
)
from tpu_speech_commands_torch.ops.cnn_lowering import (
    fold_block1_params,
    lower_block1,
    lower_classifier,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-2
MODEL_TYPES = ("simple_cnn", "simple_cnn_lite")
SHAPES = ((30, 20), (30, 40), (29, 21))
# every random (model type, shape) and both pretrained checkpoints
CASES = [(m, s) for m in MODEL_TYPES for s in SHAPES] + \
    [(m, "pretrained") for m in MODEL_TYPES]


@functools.cache
def _jax_cnn(model_type, shape):
    """(flax model, numpy variables, (h, w)) for a case."""
    model = jax_get_model(model_type, 5)
    if shape == "pretrained":
        variables, meta = load_checkpoint(
            os.path.join(REPO, "pretrained", f"direction_{model_type}.npz"))
        assert meta["num_classes"] == 5  # and the default 30 x 20 features
        return model, variables, (30, 20)
    h, w = shape
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((8, h, w, 1)).astype(np.float32)
    variables = model.init({"params": jax.random.PRNGKey(h + w)},
                           jnp.asarray(x), train=False)
    step = jax.jit(functools.partial(model.apply, train=True,
                                     mutable=["batch_stats"]))
    for i in range(3):
        xb = (2.0 * rng.standard_normal((8, h, w, 1)) + 0.3).astype(np.float32)
        _, upd = step(variables, jnp.asarray(xb),
                      rngs={"dropout": jax.random.PRNGKey(10 + i)})
        variables = {"params": variables["params"],
                     "batch_stats": upd["batch_stats"]}
    return model, jax.tree_util.tree_map(np.asarray, variables), (h, w)


def _port_model(model_type, variables, shape) -> SimpleCNN:
    model = get_model(model_type, 5, n_features=shape[0], feature_size=shape[1])
    model.load_state_dict(torch_state_from_jax(variables, model_type))
    return model.eval()


def _features(shape, seed, batch=8):
    return (3.0 * np.random.default_rng(seed).standard_normal(
        (batch,) + shape)).astype(np.float32)


@pytest.mark.parametrize("model_type,shape", CASES)
def test_model_matches_jax_apply(model_type, shape):
    jmodel, variables, hw = _jax_cnn(model_type, shape)
    x = _features(hw, seed=1)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x[..., None]),
                                   train=False))
    port = _port_model(model_type, variables, hw)
    with torch.no_grad():
        got = port(torch.tensor(x[..., None])).numpy()
        assert got.shape == (8, 5)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # the channel axis is optional, as for the JAX kernels
        np.testing.assert_allclose(port(torch.tensor(x)).numpy(), want,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_skip_block1_matches_jax(model_type):
    jmodel, variables, hw = _jax_cnn(model_type, (30, 20))
    pooled = np.abs(_features((15, 10, 16), seed=2))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(pooled), train=False,
                                   skip_block1=True))
    port = _port_model(model_type, variables, hw)
    with torch.no_grad():
        got = port(torch.tensor(pooled), skip_block1=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_type,shape", CASES)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_classifier_plain_matches_jax_kernel(model_type, shape, compute_dtype):
    jmodel, variables, hw = _jax_cnn(model_type, shape)
    x = _features(hw, seed=3)
    fused = pallas_classifier.make_fused_cnn_classifier(
        variables, separable=jmodel.separable, n_features=hw[0],
        feature_size=hw[1], batch_tile=4, interpret=True,
        compute_dtype=getattr(jnp, compute_dtype))
    want = np.asarray(fused(jnp.asarray(x)))
    port = _port_model(model_type, variables, hw)
    got = CNNClassifier(port, getattr(torch, compute_dtype))(
        torch.tensor(x)).numpy()
    assert got.shape == (8, 5) and got.dtype == np.float32
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.parametrize("model_type,shape", CASES)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_block1_plain_matches_jax_kernel(model_type, shape, compute_dtype):
    jmodel, variables, (h, w) = _jax_cnn(model_type, shape)
    x = _features((h, w), seed=4)
    want = np.asarray(jax_block1(
        variables, n_features=h, feature_size=w, separable=jmodel.separable,
        batch_tile=4, interpret=True,
        compute_dtype=getattr(jnp, compute_dtype))(jnp.asarray(x)))
    got = make_fused_conv_block1(
        variables, h, w, jmodel.separable, getattr(torch, compute_dtype),
        "cpu")(torch.tensor(x[..., None])).numpy()
    assert got.shape == (8, h // 2, w // 2, 16) == want.shape
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # and against flax's own block 1
        block = _ConvBlock(16, 1, jmodel.separable, False, True)
        flax_out = np.asarray(block.apply(
            {"params": variables["params"]["block1"],
             "batch_stats": variables["batch_stats"]["block1"]},
            jnp.asarray(x[..., None]), train=False))
        np.testing.assert_allclose(got, flax_out, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.parametrize("model_type,shape", CASES)
def test_fused_cnn_forward_matches_jax(model_type, shape):
    jmodel, variables, hw = _jax_cnn(model_type, shape)
    x = _features(hw, seed=5)
    want = np.asarray(jax_fused_forward(
        jmodel, variables, n_features=hw[0], feature_size=hw[1],
        batch_tile=4, interpret=True)(jnp.asarray(x[..., None])))
    got = make_fused_cnn_forward(_port_model(model_type, variables, hw))(
        torch.tensor(x[..., None])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_same_pads_match_jax(stride):
    for dim in range(1, 65):
        lo, hi = same_pads(dim, stride)
        assert lo == pallas_classifier._same_pad_lo(dim, stride)
        out = -(-dim // stride)
        assert lo + hi == max((out - 1) * stride + 3 - dim, 0)
    assert same_pads(10, 2) == (0, 1)  # block 3 of the use_delta shape
    assert same_pads(7, 2) == (1, 1)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fold_block1_matches_jax(model_type):
    jmodel, variables, hw = _jax_cnn(model_type, "pretrained")
    w, b = fold_block1_params(variables, jmodel.separable)
    jw, jb = jax_fold(variables, jmodel.separable)
    np.testing.assert_allclose(w, jw, rtol=1e-12, atol=0)
    np.testing.assert_allclose(b, jb, rtol=1e-12, atol=1e-15)
    stage = lower_block1(variables, jmodel.separable, *hw)
    np.testing.assert_array_equal(stage.kernel[:, :, 0, :],
                                  jw.astype(np.float32))
    np.testing.assert_array_equal(stage.bias, jb.astype(np.float32))


@pytest.mark.parametrize("model_type,shape", CASES)
def test_lowering_matches_jax_lowering(model_type, shape):
    """The JAX Toeplitz matrices, rebuilt by `_conv_matrix` from the port's
    effective kernels, equal the JAX lowering's own, and so do the epilogue
    constants and the dense arrays: the port lowers the same numbers."""
    jmodel, variables, (h, w) = _jax_cnn(model_type, shape)
    stages, final_hwc, dense_w, dense_b, head_w, head_b = \
        pallas_classifier.lower_classifier(variables, jmodel.separable, h, w)
    low = lower_classifier(variables, jmodel.separable, h, w)
    assert len(low.stages) == len(stages) == 4
    for st, js in zip(low.stages, stages):
        assert (st.h_in, st.w_in, st.stride, st.pool, st.inline_relu) == (
            js.h_in, js.w_in, js.stride, js.pool, js.inline_relu)
        assert (st.h_out, st.w_out, st.cin, st.cout) == (
            js.h_out, js.w_out, js.cin, js.cout)
        np.testing.assert_array_equal(
            pallas_classifier._conv_matrix(st.kernel, st.w_in, st.stride,
                                           st.pool), js.matrix)
        np.testing.assert_array_equal(st.bias, js.bias[0, :st.cout])
        if st.inline_relu:
            np.testing.assert_array_equal(st.pre_bias, js.pre_bias[0, :st.cout])
            np.testing.assert_array_equal(st.mult, js.scale[0, :st.cout])
    assert (low.stages[-1].h_out, low.stages[-1].w_out,
            low.stages[-1].cout) == final_hwc
    for got, want in ((low.dense_w, dense_w), (low.dense_b, dense_b[0]),
                      (low.head_w, head_w), (low.head_b, head_b[0])):
        np.testing.assert_array_equal(got, want)
    for arr in (low.dense_w, low.head_w, *(s.kernel for s in low.stages)):
        assert arr.flags.c_contiguous and arr.dtype == np.float32


def test_lowering_refuses_a_flatten_mismatch():
    _, variables, _ = _jax_cnn("simple_cnn", (30, 20))
    with pytest.raises(ValueError, match="flatten mismatch"):
        lower_classifier(variables, False, 30, 40)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_convert_carries_params_and_batch_stats(model_type):
    _, variables, hw = _jax_cnn(model_type, (29, 21))
    state = torch_state_from_jax(variables, model_type)
    model = get_model(model_type, 5, n_features=hw[0], feature_size=hw[1])
    want = model.state_dict()
    assert set(state) == set(want)
    for key, value in state.items():
        assert value.shape == want[key].shape and value.dtype == torch.float32
    stats = variables["batch_stats"]
    for name in ("block1", "block2", "block3", "block4"):
        for field in ("mean", "var"):
            np.testing.assert_array_equal(state[f"{name}.bn.{field}"].numpy(),
                                          stats[name]["bn"][field])
    if model_type == "simple_cnn_lite":
        assert state["block2.depthwise.kernel"].shape == (3, 3, 1, 16)
        assert state["block2.pointwise.kernel"].shape == (1, 1, 16, 32)
    else:
        assert state["block2.conv.kernel"].shape == (3, 3, 16, 32)
    # the model hands the same tree back
    model.load_state_dict(state)
    back = model.variables()
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


def _with(tree, path, value):
    """A copy of a nested dict with path set to value (None deletes it)."""
    out = dict(tree)
    if len(path) == 1:
        if value is None:
            del out[path[0]]
        else:
            out[path[0]] = value
        return out
    out[path[0]] = _with(tree[path[0]], path[1:], value)
    return out


@pytest.mark.parametrize("path,value,match", [
    (("batch_stats",), None, "batch_stats"),
    (("params", "block2", "conv", "kernel"), np.zeros((3, 3, 16, 31)),
     "block2/conv/kernel"),
    (("params", "block4", "bn", "scale"), np.zeros(127), "block4/bn/scale"),
    (("batch_stats", "block3", "bn", "var"), None, "block3/bn"),
    (("params", "extra"), {"kernel": np.zeros(1)}, "parameter groups"),
    (("params", "block1", "depthwise"), {"kernel": np.zeros((3, 3, 1, 1))},
     "block1 holds"),
    (("params", "feature_dense", "kernel"), np.zeros((256, 64)),
     "feature_dense"),
    (("params", "score_predict", "kernel"), np.zeros((127, 5)),
     "score_predict/kernel"),
])
def test_convert_rejects_bad_cnn_trees(path, value, match):
    _, variables, _ = _jax_cnn("simple_cnn", "pretrained")
    with pytest.raises(ValueError, match=match):
        torch_state_from_jax(_with(variables, path, value), "simple_cnn")


def test_convert_rejects_a_dense_tree_as_lite():
    _, variables, _ = _jax_cnn("simple_cnn", "pretrained")
    with pytest.raises(ValueError, match="block1 holds"):
        torch_state_from_jax(variables, "simple_cnn_lite")


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_dispatchers_on_cpu_are_the_plain_versions(compute_dtype):
    _, variables, hw = _jax_cnn("simple_cnn_lite", (30, 40))
    port = _port_model("simple_cnn_lite", variables, hw)
    x = torch.tensor(_features(hw, seed=6, batch=5))
    cls = CNNClassifier(port, compute_dtype)
    want = cnn_kernel.cnn_classifier_plain(cls.consts, x)
    torch.testing.assert_close(cls(x), want, rtol=0, atol=0)
    torch.testing.assert_close(cls(x[..., None]), want, rtol=0, atol=0)
    assert cls(x[:0]).shape == (0, 5)
    block1 = make_fused_conv_block1(variables, *hw, True, compute_dtype, "cpu")
    stage = cnn_kernel.StageTensors(lower_block1(variables, True, *hw), "cpu",
                                    compute_dtype)
    torch.testing.assert_close(block1(x), cnn_kernel.cnn_block1_plain(stage, x),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\(B, 30, 40\)"):
        cls(x[:, :, :20].contiguous())
    with pytest.raises(ValueError, match=r"\(B, 30, 40\)"):
        block1(x[:, :29].contiguous())
    with pytest.raises(TypeError):
        cls(x.double())


def test_raw_wrappers_refuse_cpu_tensors():
    _, variables, hw = _jax_cnn("simple_cnn", (30, 20))
    consts = CNNClassifier(_port_model("simple_cnn", variables, hw)).consts
    x = torch.zeros(2, *hw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cnn_kernel.cnn_classifier_cuda(x, consts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cnn_kernel.cnn_block1_cuda(x, consts.stages[0])
    with pytest.raises(ValueError, match="block-1 kernel"):
        cnn_kernel.cnn_block1_cuda(x, consts.stages[3])


def test_kernel_constants_row_major_and_typed():
    """Everything handed to the kernel through data_ptr() is a contiguous
    row-major tensor; matmul weights in the compute dtype, the epilogue
    constants in float32."""
    _, variables, hw = _jax_cnn("simple_cnn_lite", "pretrained")
    port = _port_model("simple_cnn_lite", variables, hw)
    for dtype in (torch.float32, torch.bfloat16):
        consts = CNNClassifier(port, dtype).consts
        for st in consts.stages:
            assert st.kernel.dtype == dtype and st.kernel.is_contiguous()
            assert st.kernel.shape == (3, 3, st.stage.cin, st.stage.cout)
            for t in (st.bias, st.pre_bias, st.mult):
                assert t is None or (t.dtype == torch.float32
                                     and t.is_contiguous())
            assert len(st.dims()) == 8
        assert (st.pre_bias is not None) and consts.stages[0].pre_bias is None
        assert consts.dense_w.dtype == consts.head_w.dtype == dtype
        assert consts.dense_b.dtype == consts.head_b.dtype == torch.float32
        np.testing.assert_array_equal(
            consts.stages[1].kernel.float().numpy(),
            torch.tensor(lower_classifier(variables, True, *hw).stages[1].kernel)
            .to(dtype).float().numpy())


def test_bn_epsilon_is_keras():
    """BatchNorm divides by sqrt(var + 1e-3): with var 0 a unit input maps
    to 1 / sqrt(1e-3), where torch's 1e-5 would give 10x that."""
    model = get_model("simple_cnn", 2, n_features=16, feature_size=16)
    bn = model.block1.bn
    with torch.no_grad():
        bn.var.zero_()
        got = bn(torch.ones(1, 16, 1, 1))
    torch.testing.assert_close(got, torch.full((1, 16, 1, 1), 1e-3 ** -0.5))
