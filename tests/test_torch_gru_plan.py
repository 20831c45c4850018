"""The GRU tile kernel's plan (`ops/gru_plan.py`) on the CPU: its route,
padding, fragment maps and weight pack, and its emulation of the kernel's
warps against the plain module (`models/rnn.py::SimpleGRU`) and the JAX
fused kernel in interpret mode.

Weights are seeded numpy arrays in the JAX package's tree, carried over with
`convert.torch_state_from_jax`; B = 17 leaves the second warp with one
window.  Tolerances, as tests/test_torch_rnn.py holds the plain module to
the JAX kernel:
- f32: rtol 1e-4 / atol 1e-5 (the same math, f32 sums in another order);
- bf16 (bf16 products, f32 accumulation and gates): atol 5e-2, the bound
  tests/test_serving.py allows bf16 scores (a rounding can flip at a bf16
  boundary and grow over the steps).

The CUDA kernel itself against the plain module: tests/test_torch_gpu.py.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.ops.pallas_rnn import make_fused_rnn_classifier
from tpu_speech_commands_torch.convert import torch_state_from_jax
from tpu_speech_commands_torch.models.rnn import SimpleGRU
from tpu_speech_commands_torch.ops import _build
from tpu_speech_commands_torch.ops import gru_plan as gp

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-2
T, B = 30, 17
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _variables(d_in, units, layers, seed, classes=5):
    """A GRU tree as the JAX package holds it, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def weight(rows, cols):
        return (0.7 / np.sqrt(rows) * rng.standard_normal((rows, cols))
                ).astype(np.float32)

    def bias(n):
        return (0.1 * rng.standard_normal(n)).astype(np.float32)

    backbone = {
        f"gru_unit_{i}": {
            "kernel": weight(d_in if i == 0 else units, 3 * units),
            "recurrent_kernel": weight(units, 3 * units),
            "bias_input": bias(3 * units), "bias_recurrent": bias(3 * units)}
        for i in range(layers)}
    return {"params": {"backbone": backbone, "score_predict": {
        "kernel": weight(units, classes), "bias": bias(classes)}}}


def _model(variables, d_in, units, layers):
    model = SimpleGRU(5, d_in, units, layers)
    model.load_state_dict(torch_state_from_jax(variables, "simple_gru"))
    return model.eval()


def _features(d_in, seed=42, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, T, d_in)).astype(np.float32)


def _emulate(model, x, compute_dtype, **maps):
    """The model's layers through the emulation, the head on the last."""
    cells = model.backbone.cells()
    seq = x
    for i, cell in enumerate(cells):
        pack = gp.pack_gru_weights(cell.kernel, cell.recurrent_kernel,
                                   cell.bias_input, cell.bias_recurrent,
                                   compute_dtype)
        last = i == len(cells) - 1
        head = model.score_predict
        seq = gp.emulate(pack, seq, head.kernel if last else None,
                         head.bias if last else None, **maps)
    return seq


def _close(got, want, dtype):
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.parametrize("d_in,units,route", [
    (20, 48, "tile"),    # every shipped checkpoint
    (48, 48, "tile"),    # layer 2 of a stacked model
    (3, 4, "tile"), (1, 1, "tile"), (64, 64, "tile"), (40, 64, "tile"),
    (65, 48, "proj"), (20, 65, "simt"), (80, 80, "simt"), (20, 1024, "simt"),
])
def test_kernel_for_each_width(d_in, units, route):
    assert gp.gru_kernel_for(d_in, units) == route


def test_padding_is_to_a_k_block():
    assert [gp.padded(n) for n in (1, 4, 16, 17, 20, 48, 64)] == [
        16, 16, 16, 32, 32, 48, 64]
    assert gp.padded(20) == gp.SHIPPED[0] and gp.padded(48) == gp.SHIPPED[1]


def test_fragment_maps_are_the_ptx_layout():
    """mma.m16n8k16 .bf16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"):
    groupID = lane >> 2, threadID_in_group = lane % 4.  A: a0, a1, a4, a5
    in row groupID, the others 8 below; columns 2 tig + (i & 1), 8 more for
    a4 .. a7.  B: rows 2 tig + (i & 1), 8 more for b2, b3; column groupID.
    C: c0, c1 in row groupID, c2, c3 8 below; columns 2 tig + (i & 1)."""
    for lane in range(32):
        g, tig = lane >> 2, lane % 4
        for i in range(8):
            assert gp.A_ROW[lane, i] == g + (8 if i in (2, 3, 6, 7) else 0)
            assert gp.A_COL[lane, i] == 2 * tig + (i & 1) + (8 if i >= 4 else 0)
        for i in range(4):
            assert gp.B_ROW[lane, i] == 2 * tig + (i & 1) + (8 if i >= 2 else 0)
            assert gp.B_COL[lane, i] == g
            assert gp.C_ROW[lane, i] == g + (8 if i >= 2 else 0)
            assert gp.C_COL[lane, i] == 2 * tig + (i & 1)
    # each map covers its tile once
    for rows, cols, shape in ((gp.A_ROW, gp.A_COL, (16, 16)),
                              (gp.B_ROW, gp.B_COL, (16, 8)),
                              (gp.C_ROW, gp.C_COL, (16, 8))):
        seen = np.zeros(shape, int)
        np.add.at(seen, (rows, cols), 1)
        assert (seen == 1).all()


def test_accumulators_of_two_n_tiles_are_an_a_fragment():
    """The register reuse: a lane's C elements of n-tiles 2k and 2k + 1 sit
    where its A elements of k-block k sit, so the new h is the next step's
    A operand without a shuffle."""
    for lane in range(32):
        for i, (n, c) in enumerate(gp.C_TO_A):
            assert gp.A_ROW[lane, i] == gp.C_ROW[lane, c]
            assert gp.A_COL[lane, i] == 8 * n + gp.C_COL[lane, c]
    # f32 mode: rows g and g + 8 are one float2 of the per-warp buffer
    rows = np.arange(16)
    assert sorted(gp.slot(rows)) == list(range(16))
    assert (gp.slot(rows[8:]) == gp.slot(rows[:8]) + 1).all()
    assert gp.X_PITCH >= 16


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d_in,units", [(3, 4), (20, 48), (64, 64), (17, 33)])
def test_pack_round_trips_to_the_keras_layout(d_in, units, dtype):
    cd = DTYPES[dtype]
    cell = _model(_variables(d_in, units, 1, seed=units), d_in, units,
                  1).backbone.gru_unit_0
    pack = gp.pack_gru_weights(cell.kernel, cell.recurrent_kernel,
                               cell.bias_input, cell.bias_recurrent, cd)
    d_p, u_p = gp.padded(d_in), gp.padded(units)
    assert (pack.d_p, pack.u_p) == (d_p, u_p)
    if cd == torch.bfloat16:
        assert pack.weights.dtype == torch.bfloat16
        assert pack.weights.shape == ((d_p + u_p) // 16, 3 * u_p // 8, 32, 4)
    else:
        assert pack.weights.shape == (d_p + u_p, 3 * u_p)
    m = gp.unpack_matrix(pack).reshape(d_p + u_p, 3, u_p)
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
        bi = cell.bias_input.reshape(3, units)
        br = cell.bias_recurrent.reshape(3, units)
        want = torch.stack([bi[0] + br[0], bi[1] + br[1], bi[2], br[2]])
        torch.testing.assert_close(pack.bias[:, :units], want, rtol=0, atol=0)
        assert (pack.bias[:, units:] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("units", [4, 33])
def test_padded_units_stay_exactly_zero(units, dtype):
    """z = r = sigmoid(0) = 1/2 and cand = 0 in a padded unit: h = h / 2
    from h = 0, at every step, in both modes."""
    cd = DTYPES[dtype]
    cell = _model(_variables(20, units, 1, seed=5), 20, units,
                  1).backbone.gru_unit_0
    pack = gp.pack_gru_weights(cell.kernel, cell.recurrent_kernel,
                               cell.bias_input, cell.bias_recurrent, cd)
    seq = gp.emulate(pack, torch.tensor(_features(20)), padded_units=True)
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


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_emulation_at_either_windows_a_warp(dtype, rows):
    """8 windows a warp leave rows g + 8 of each tile idle; 16 fill them.
    B = 17 leaves the last warp ragged either way."""
    model = _model(_variables(20, 48, 1, seed=4), 20, 48, 1)
    x = torch.tensor(_features(20))
    cd = DTYPES[dtype]
    cell, head = model.backbone.gru_unit_0, model.score_predict
    pack = gp.pack_gru_weights(cell.kernel, cell.recurrent_kernel,
                               cell.bias_input, cell.bias_recurrent, cd)
    with torch.no_grad():
        want = model(x, cd).numpy()
        got = gp.emulate(pack, x, head.kernel, head.bias, rows=rows).numpy()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_emulation_takes_bf16_features(dtype):
    """bf16 features, as the scorer hands them over in bf16: the kernel
    reads them as they are."""
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
    """The JAX kernel in interpret mode, as tests/test_torch_rnn.py runs it,
    one batch tile of all 17 windows."""
    variables = _variables(d_in, units, layers, seed=11)
    x = _features(d_in, seed=3)
    fused = make_fused_rnn_classifier(
        variables, cell_type="gru", n_features=T, feature_size=d_in,
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
    """csrc/gru_classifier.cu and the plan hold the same constants: windows
    a warp and warps a block, the width caps, the f32 buffer's pitch, the
    shipped shape; the instantiated (D_p, U_p) are every pair up to the
    caps, and 8 windows a warp the shipped shape, which is all the sweep
    asks for."""
    src = (_build.CSRC_DIR / "gru_classifier.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRows") == gp.ROWS == gp.TILE
    assert const("kWarps") == gp.WARPS
    assert const("kCapD") == gp.CAP_D
    assert const("kCapU") == gp.CAP_U
    assert const("kXPitch") == gp.X_PITCH
    assert (const("kShippedD"), const("kShippedU")) == gp.SHIPPED
    assert max(w for _, w in gp.SWEEP) <= const("kMaxWarps")
    assert {r for r, _ in gp.SWEEP} == {8, gp.ROWS}
    assert (gp.ROWS, gp.WARPS) in gp.SWEEP
    shapes = src[src.index("#define TSC_GRU_TILE_SHAPES(X)"):]
    shapes = shapes[:shapes.index("\n\n")]
    pairs = {(int(d), int(u)) for d, u in re.findall(r"X\((\d+), (\d+)\)",
                                                     shapes)}
    assert pairs == {(d, u) for d in range(gp.PAD, gp.CAP_D + 1, gp.PAD)
                     for u in range(gp.PAD, gp.CAP_U + 1, gp.PAD)}
    assert "rows == kRows" in src and \
        "DP == kShippedD && UP == kShippedU && rows == 8" in src


def test_ablation_variants_each_match_the_kernel_source_once():
    """dev/gru_ablation.py edits csrc/gru_classifier.cu by text: each text
    a variant replaces is in the source once, and each variant differs."""
    from tpu_speech_commands_torch.dev import gru_ablation

    sources = gru_ablation.variant_sources()
    assert set(sources) == {"base", *gru_ablation.CHOICES}
    assert len(set(sources.values())) == len(sources)
    assert "1.0f / (dz[e])" in sources["true_divide"]
    assert "kMaxWarps * 32)" in sources["no_min_blocks"]
    assert sources["all_undone"].count("rcp_rn(dz[e])") == 0
