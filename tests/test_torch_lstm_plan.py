"""The LSTM tile kernel's plan (`ops/lstm_plan.py`) on the CPU: its route,
padding and weight pack, and its emulation of the kernel's warps against
the plain module (`models/rnn.py::SimpleLSTM`) and the JAX fused kernel in
interpret mode.

Weights are seeded numpy arrays in the JAX package's tree, carried over with
`convert.torch_state_from_jax`; B = 17 leaves the second warp with one
window.  Tolerances, as tests/test_torch_gru_plan.py holds the GRU's
emulation:
- f32: rtol 1e-4 / atol 1e-5 (the same math, f32 sums in another order);
- bf16 (bf16 products, f32 accumulation, cell and gates): atol 5e-2, the
  bound tests/test_serving.py allows bf16 scores (a rounding can flip at a
  bf16 boundary and grow over the steps).

The CUDA kernel itself against the plain module: tests/test_torch_gpu.py.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.ops.pallas_rnn import make_fused_rnn_classifier
from tpu_speech_commands_torch.convert import torch_state_from_jax
from tpu_speech_commands_torch.models.rnn import SimpleLSTM
from tpu_speech_commands_torch.ops import _build
from tpu_speech_commands_torch.ops import gru_plan as gp
from tpu_speech_commands_torch.ops import lstm_plan as lp

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-2
T, B = 30, 17
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _variables(d_in, units, layers, seed, classes=5):
    """An LSTM tree as the JAX package holds it, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def weight(rows, cols):
        return (0.7 / np.sqrt(rows) * rng.standard_normal((rows, cols))
                ).astype(np.float32)

    backbone = {
        f"lstm_unit_{i}": {
            "kernel": weight(d_in if i == 0 else units, 4 * units),
            "recurrent_kernel": weight(units, 4 * units),
            "bias": (0.1 * rng.standard_normal(4 * units)).astype(np.float32)}
        for i in range(layers)}
    return {"params": {"backbone": backbone, "score_predict": {
        "kernel": weight(units, classes),
        "bias": (0.1 * rng.standard_normal(classes)).astype(np.float32)}}}


def _model(variables, d_in, units, layers):
    model = SimpleLSTM(5, d_in, units, layers)
    model.load_state_dict(torch_state_from_jax(variables, "simple_lstm"))
    return model.eval()


def _features(d_in, seed=42):
    return np.random.default_rng(seed).standard_normal(
        (B, T, d_in)).astype(np.float32)


def _pack(cell, compute_dtype):
    return lp.pack_lstm_weights(cell.kernel, cell.recurrent_kernel,
                                cell.bias, compute_dtype)


def _emulate(model, x, compute_dtype, **maps):
    """The model's layers through the emulation, the head on the last."""
    cells = model.backbone.cells()
    seq = x
    for i, cell in enumerate(cells):
        last = i == len(cells) - 1
        head = model.score_predict
        seq = lp.emulate(_pack(cell, compute_dtype), seq,
                         head.kernel if last else None,
                         head.bias if last else None, **maps)
    return seq


def _close(got, want, dtype):
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.parametrize("d_in,units,route", [
    (20, 48, "tile"),    # the shipped checkpoint
    (48, 48, "tile"),    # layer 2 of a stacked model
    (3, 4, "tile"), (1, 1, "tile"), (64, 64, "tile"), (40, 64, "tile"),
    (65, 48, "simt"), (20, 65, "simt"), (80, 80, "simt"), (20, 1024, "simt"),
])
def test_kernel_for_each_width(d_in, units, route):
    assert lp.lstm_kernel_for(d_in, units) == route


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d_in,units", [(3, 4), (20, 48), (64, 64), (17, 33)])
def test_pack_round_trips_to_the_keras_layout(d_in, units, dtype):
    cd = DTYPES[dtype]
    cell = _model(_variables(d_in, units, 1, seed=units), d_in, units,
                  1).backbone.lstm_unit_0
    pack = _pack(cell, cd)
    d_p, u_p = gp.padded(d_in), gp.padded(units)
    assert (pack.d_p, pack.u_p) == (d_p, u_p)
    if cd == torch.bfloat16:
        assert pack.weights.dtype == torch.bfloat16
        assert pack.weights.shape == ((d_p + u_p) // 16, 4 * u_p // 8, 32, 4)
    else:
        assert pack.weights.shape == (d_p + u_p, 4 * u_p)
    m = gp.unpack_matrix(pack).reshape(d_p + u_p, 4, u_p)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if cd == torch.bfloat16 \
        else (lambda t: t)
    with torch.no_grad():
        torch.testing.assert_close(m[:d_in, :, :units].reshape(d_in, -1),
                                   rnd(cell.kernel), rtol=0, atol=0)
        torch.testing.assert_close(
            m[d_p:d_p + units, :, :units].reshape(units, -1),
            rnd(cell.recurrent_kernel), rtol=0, atol=0)
        pad = torch.ones_like(m, dtype=torch.bool)
        pad[:d_in, :, :units] = False
        pad[d_p:d_p + units, :, :units] = False
        assert (m[pad] == 0).all()
        torch.testing.assert_close(pack.bias[:, :units],
                                   cell.bias.reshape(4, units), rtol=0, atol=0)
        assert (pack.bias[:, units:] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("units", [4, 33])
def test_padded_units_stay_exactly_zero(units, dtype):
    """i = f = o = sigmoid(0) = 1/2 and tanh(0) = 0 in a padded unit: c =
    c / 2 + 0 and h = tanh(c) / 2 stay 0 from 0, at every step, in both
    modes."""
    cell = _model(_variables(20, units, 1, seed=5), 20, units,
                  1).backbone.lstm_unit_0
    seq = lp.emulate(_pack(cell, DTYPES[dtype]),
                     torch.tensor(_features(20)), padded_units=True)
    assert seq.shape == (B, T, gp.padded(units))
    assert (seq[:, :, units:] == 0).all()
    assert (seq[:, :, :units].abs().amax((0, 1)) > 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("d_in", [3, 20])
@pytest.mark.parametrize("units", [4, 16, 48])
def test_emulation_meets_the_plain_version(units, d_in, layers, dtype):
    model = _model(_variables(d_in, units, layers, seed=units + d_in),
                   d_in, units, layers)
    x = torch.tensor(_features(d_in))
    cd = DTYPES[dtype]
    with torch.no_grad():
        want = model(x, cd).numpy()
        got = _emulate(model, x, cd).numpy()
    assert got.shape == (B, 5)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_emulation_takes_bf16_features(dtype):
    """bf16 features, as a bf16 frontend hands them over: the kernel reads
    them as they are."""
    model = _model(_variables(20, 48, 1, seed=2), 20, 48, 1)
    x = torch.tensor(_features(20)).to(torch.bfloat16)
    cd = DTYPES[dtype]
    with torch.no_grad():
        want = model(x, cd).numpy()
        got = _emulate(model, x, cd).numpy()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d_in,units,layers", [(20, 48, 1), (3, 4, 2)])
def test_emulation_meets_the_jax_kernel(d_in, units, layers, dtype):
    """The JAX kernel in interpret mode, as tests/test_torch_lstm.py runs it,
    one batch tile of all 17 windows."""
    variables = _variables(d_in, units, layers, seed=11)
    x = _features(d_in, seed=3)
    fused = make_fused_rnn_classifier(
        variables, cell_type="lstm", n_features=T, feature_size=d_in,
        batch_tile=B, interpret=True, compute_dtype=getattr(jnp, dtype))
    want = np.asarray(fused(jnp.asarray(x)))
    model = _model(variables, d_in, units, layers)
    with torch.no_grad():
        got = _emulate(model, torch.tensor(x), DTYPES[dtype]).numpy()
    _close(got, want, dtype)


WRONG_MAPS = {
    # the C -> A repack with rows g and g + 8 swapped
    "bfloat16": {"c_to_a": ((0, 2), (0, 3), (0, 0), (0, 1),
                            (1, 2), (1, 3), (1, 0), (1, 1))},
    # the f32 mode's h written with rows g and g + 8 swapped
    "float32": {"h_slot": lambda row: gp.slot(row) ^ 1},
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_wrong_map_fails_the_emulation(dtype):
    """The emulation hands h on by its maps: one row swap in the map takes
    the logits outside the tolerance of the plain version."""
    model = _model(_variables(20, 48, 1, seed=9), 20, 48, 1)
    x = torch.tensor(_features(20))
    cd = DTYPES[dtype]
    with torch.no_grad():
        want = model(x, cd)
        right = _emulate(model, x, cd)
        wrong = _emulate(model, x, cd, **WRONG_MAPS[dtype])
    tol = ATOL + RTOL * want.abs() if dtype == "float32" else BF16_ATOL
    assert ((right - want).abs() <= tol).all()
    assert ((wrong - want).abs() > tol).any()


def test_the_cuda_source_is_instantiated_as_the_plan_says():
    """csrc/lstm_classifier.cu and the plan hold the same constants: windows
    a warp and warps a block, the width caps, the f32 buffer's pitch; the
    instantiated (D_p, U_p) are every pair up to the caps; both .cu files
    take the shared pieces from one header."""
    src = (_build.CSRC_DIR / "lstm_classifier.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRows") == lp.ROWS == gp.TILE
    assert const("kWarps") == lp.WARPS
    assert const("kCapD") == lp.CAP_D
    assert const("kCapU") == lp.CAP_U
    assert const("kXPitch") == lp.X_PITCH
    assert lp.WARPS <= const("kMaxWarps")
    shapes = src[src.index("#define TSC_LSTM_TILE_SHAPES(X)"):]
    shapes = shapes[:shapes.index("\n\n")]
    pairs = {(int(d), int(u)) for d, u in re.findall(r"X\((\d+), (\d+)\)",
                                                     shapes)}
    assert pairs == {(d, u) for d in range(gp.PAD, lp.CAP_D + 1, gp.PAD)
                     for u in range(gp.PAD, lp.CAP_U + 1, gp.PAD)}
    for name in ("lstm_classifier.cu", "gru_classifier.cu"):
        text = (_build.CSRC_DIR / name).read_text()
        assert '#include "rnn_tile.cuh"' in text
        assert "float rcp_sigmoid(" not in text  # one source, one check
    assert "float rcp_sigmoid(" in (_build.CSRC_DIR / "rnn_tile.cuh").read_text()


def test_ablation_variants_each_match_the_kernel_source_once():
    """dev/lstm_ablation.py edits csrc/lstm_classifier.cu by text: each text
    a variant replaces is in the source once, and each variant differs."""
    from tpu_speech_commands_torch.dev import lstm_ablation

    sources = lstm_ablation.variant_sources()
    assert set(sources) == {"base", *lstm_ablation.CHOICES,
                            *lstm_ablation.CUTS}
    assert len(set(sources.values())) == len(sources)
    assert "1.0f / (di[e])" in sources["true_divide"]
    assert "kMaxWarps * 32)" in sources["no_min_blocks"]
    assert sources["all_undone"].count("rcp_rn(di[e])") == 0
