"""The GRU and LSTM classifiers' projected route on the CPU: inputs wider
than the tile kernels take (D_p > `gru_plan.CAP_D`) run the input
projection (`ops/rnn_projection.py`, `csrc/rnn_projection.cu`) and then the
tile kernel in projected mode, its accumulators started from XW.

Here the projection runs through its plain version
(`rnn_projection_plain`) and its emulation from the pack, the recurrence
through `gru_plan.WarpTiles` (the kernels' fragment maps), and the whole
is held to the plain module (`models/rnn.py`) and to the JAX fused kernel
in interpret mode, on the same numpy-seeded weights (the JAX tree,
carried over with `convert.torch_state_from_jax`) and features.  B = 19
leaves the second warp of 16 windows with three; T = 5.

Tolerances, those of tests/test_torch_rnn.py, tests/test_torch_gru_plan.py
and tests/test_torch_lstm_plan.py:
- f32: rtol 1e-4 / atol 1e-5 (the same math, f32 sums in another order);
- bf16 (bf16 products, f32 accumulation and gates): atol 5e-2, the bound
  tests/test_serving.py allows bf16 scores.

The plan half of fault 3.10 (the SIMT kernels' block refused past 232,448
bytes from about 300 GRU / 220 LSTM features): every D up to 1200 at 48
units has a route whose blocks fit.  The CUDA kernels themselves against
the plain module: tests/test_torch_gpu.py.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.ops.pallas_rnn import make_fused_rnn_classifier
from tpu_speech_commands_torch.convert import torch_state_from_jax
from tpu_speech_commands_torch.models.rnn import SimpleGRU, SimpleLSTM
from tpu_speech_commands_torch.ops import _build
from tpu_speech_commands_torch.ops import gru_plan as gp
from tpu_speech_commands_torch.ops import lstm_plan as lp
from tpu_speech_commands_torch.ops import rnn_projection as rp
from tpu_speech_commands_torch.ops.rnn_kernel import (GRUClassifier,
                                                      LSTMClassifier)

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-2
T, B, UNITS = 5, 19, 48
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CELLS = {"gru": (SimpleGRU, 3), "lstm": (SimpleLSTM, 4)}


def _variables(cell, d_in, units, seed, classes=5):
    """A one-layer tree as the JAX package holds it, from a numpy seed."""
    rng = np.random.default_rng(seed)
    gates = CELLS[cell][1]

    def weight(rows, cols):
        return (0.7 / np.sqrt(rows) * rng.standard_normal((rows, cols))
                ).astype(np.float32)

    def bias(n):
        return (0.1 * rng.standard_normal(n)).astype(np.float32)

    layer = {"kernel": weight(d_in, gates * units),
             "recurrent_kernel": weight(units, gates * units)}
    if cell == "gru":
        layer.update(bias_input=bias(3 * units), bias_recurrent=bias(3 * units))
    else:
        layer.update(bias=bias(4 * units))
    return {"params": {"backbone": {f"{cell}_unit_0": layer},
                       "score_predict": {"kernel": weight(units, classes),
                                         "bias": bias(classes)}}}


def _model(cell, variables, d_in):
    model = CELLS[cell][0](5, d_in, UNITS, 1)
    model.load_state_dict(torch_state_from_jax(variables, f"simple_{cell}"))
    return model.eval()


def _features(d_in, seed=7, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, T, d_in)).astype(np.float32)


def _projected_pack(cell, layer, compute_dtype):
    if cell == "gru":
        return rp.pack_gru_projected(layer.kernel, layer.recurrent_kernel,
                                     layer.bias_input, layer.bias_recurrent,
                                     compute_dtype)
    return rp.pack_lstm_projected(layer.kernel, layer.recurrent_kernel,
                                  layer.bias, compute_dtype)


def _xw_bias(cell, layer):
    return layer.bias_input if cell == "gru" else layer.bias


def _emulate(cell, model, x, compute_dtype, xw=None):
    """The projected route on the CPU: XW (the plain projection unless
    given), then the tile kernel's warps in projected mode with the head."""
    layer = model.backbone.cells()[0]
    pack = _projected_pack(cell, layer, compute_dtype)
    if xw is None:
        xw = rp.rnn_projection_plain(x, layer.kernel, _xw_bias(cell, layer),
                                     UNITS, compute_dtype)
    emulate = gp.emulate if cell == "gru" else lp.emulate
    head = model.score_predict
    return emulate(pack.recurrence, x[:, :, :0], head.kernel, head.bias,
                   xw=xw)


def _close(got, want, dtype):
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


@pytest.mark.parametrize("gates", [3, 4])
@pytest.mark.parametrize("steps", [1, 23, 30, 99])
def test_every_width_to_1200_has_a_route_that_fits(steps, gates):
    """At 48 units every D of 1 .. 1200 takes the tile kernel (D_p <= 64)
    or the projected route, and every block of it fits the opt-in shared
    memory in both modes: the tile kernel's, or the projection's and the
    recurrence's (neither depends on D or T).  The SIMT kernel, the route
    above 64 features before, is refused from 305 GRU / 227 LSTM features
    at 23 frames (fault 3.10)."""
    kernel_for = gp.gru_kernel_for if gates == 3 else lp.lstm_kernel_for
    u_p = gp.padded(UNITS)
    for d_in in range(1, 1201):
        route = kernel_for(d_in, UNITS)
        assert route == ("tile" if d_in <= gp.CAP_D else "proj")
        for bf16 in (False, True):
            if route == "tile":
                blocks = [gp.tile_smem_bytes(gp.padded(d_in), u_p, bf16, gates)]
            else:
                assert rp.takes(gates * u_p)
                blocks = [gp.tile_smem_bytes(0, u_p, bf16, gates),
                          rp.smem_bytes(gates * u_p, bf16, True),
                          rp.smem_bytes(gates * u_p, bf16, False)]
            assert max(blocks) <= gp.SMEM_OPTIN, (d_in, bf16, blocks)
    limit = {3: 304, 4: 226}[gates]
    assert gp.simt_smem_bytes(23, limit, UNITS, gates) <= gp.SMEM_OPTIN
    assert gp.simt_smem_bytes(23, limit + 1, UNITS, gates) > gp.SMEM_OPTIN


@pytest.mark.parametrize("d_in,units,route", [
    (64, 64, "tile"), (65, 64, "proj"), (300, 48, "proj"), (1200, 16, "proj"),
    (20, 65, "simt"), (300, 80, "simt")])
def test_route_of_each_width(d_in, units, route):
    assert gp.gru_kernel_for(d_in, units) == route
    assert lp.lstm_kernel_for(d_in, units) == route


def _source(name):
    return (_build.CSRC_DIR / name).read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _c_function(src, name):
    """A one-return constexpr function of the source as a Python lambda:
    casts dropped, `a ? b : c` as Python's conditional, `&&`, `||` and `!`
    as `and`, `or` and `not`."""
    m = re.search(rf"constexpr \w+ {name}\(([^)]*)\) \{{\s*return (.*?);\s*\}}",
                  src, re.S)
    params = [p.split()[-1] for p in m.group(1).split(",")]
    expr = re.sub(r"\(size_t\)", "", " ".join(m.group(2).split()))
    expr = re.sub(r"!(?!=)", " not ", expr.replace("&&", " and ").replace(
        "||", " or "))

    def ternary(text):
        depth = 0
        for i, ch in enumerate(text):
            depth += ch == "("
            depth -= ch == ")"
            if ch == "?" and depth == 0:
                cond, rest = text[:i], text[i + 1:]
                d = 0
                for j, c in enumerate(rest):
                    d += c == "("
                    d -= c == ")"
                    if c == ":" and d == 0:
                        return (f"(({ternary(rest[:j])}) if ({cond}) else "
                                f"({ternary(rest[j + 1:])}))")
        return text

    def convert(text):
        out, i = "", 0
        while i < len(text):
            if text[i] == "(":
                depth, j = 1, i + 1
                while depth:
                    depth += {"(": 1, ")": -1}.get(text[j], 0)
                    j += 1
                out += "(" + convert(text[i + 1:j - 1]) + ")"
                i = j
            else:
                out += text[i]
                i += 1
        return ternary(out)

    expr = convert(expr).replace("/", "//")
    return eval(f"lambda {', '.join(params)}: {expr}")


def test_the_projection_source_is_the_plan():
    """csrc/rnn_projection.cu and ops/rnn_projection.py hold the same
    constants, instantiations and shared-memory sizes."""
    src = _source("rnn_projection.cu")
    for c_name, py in (("kWarps", rp.WARPS), ("kTilesM", rp.TILES_M),
                       ("kKPad", rp.K_PAD), ("kBK32", rp.BK_F32),
                       ("kBK16", rp.BK_BF16), ("kPitch32", rp.PITCH_F32),
                       ("kPitch16", rp.PITCH_BF16), ("kStages", rp.STAGES),
                       ("kAsyncStages32", rp.ASYNC_STAGES_F32),
                       ("kAsyncStages16", rp.ASYNC_STAGES_BF16),
                       ("kTwoBlockNtw", rp.TWO_BLOCK_NTW),
                       ("kTwoBlockStages32", rp.TWO_BLOCK_STAGES_F32)):
        assert _const(src, c_name) == py, c_name
    widths = re.search(r"#define TSC_PROJECTION_WIDTHS\(X\) (.*)", src).group(1)
    assert tuple(int(n) for n in re.findall(r"X\((\d+)\)", widths)) == \
        rp.N_TILES_A_WARP
    env = {c: _const(src, c) for c in (
        "kTilesM", "kPitch16", "kPitch32", "kStages", "kBK16", "kBK32",
        "kAsyncStages32", "kAsyncStages16", "kTwoBlockNtw",
        "kTwoBlockStages32")}
    fns = {name: _c_function(src, name) for name in (
        "a_stage_bytes", "b_stage_bytes", "two_blocks", "ring_stages",
        "proj_smem")}
    for fn in fns.values():
        fn.__globals__.update(env, **fns, true=True, false=False)
    for ntw in rp.N_TILES_A_WARP:
        for bf16 in (False, True):
            for async_rows in (False, True):
                assert fns["proj_smem"](bf16, async_rows, 2 * ntw) == \
                    rp.smem_bytes(16 * ntw, bf16, async_rows)
    for gates in (3, 4):
        for u_p in range(16, gp.CAP_U + 1, 16):
            assert rp.takes(gates * u_p)
    assert "tsc_rnn_projection(const void* x, int x_bf16, int batch" in src


@pytest.mark.parametrize("name,gates", [("gru_classifier.cu", 3),
                                        ("lstm_classifier.cu", 4)])
def test_the_tile_sources_shared_memory_is_the_plan(name, gates):
    """`gru_plan.tile_smem_bytes` is `tile_smem` of each tile kernel's
    source, the projected mode's ring (D_p 0) included, and both sources
    instantiate projected mode at every U_p up to the cap."""
    src = _source(name)
    fn = _c_function(src, "tile_smem")
    fn.__globals__.update(kXPitch=_const(src, "kXPitch"),
                          kWarps=_const(src, "kWarps"), true=True,
                          false=False)
    warps_all = range(1, 9) if gates == 3 else (gp.WARPS,)
    for d_p in range(0, gp.CAP_D + 1, 16):
        for u_p in range(16, gp.CAP_U + 1, 16):
            for warps in warps_all:
                for bf16 in (False, True):
                    fn.__globals__["kBf16"] = bf16
                    args = (d_p, u_p, warps) if gates == 3 else (d_p, u_p)
                    assert fn(*args) == gp.tile_smem_bytes(
                        d_p, u_p, bf16, gates, warps), (d_p, u_p, warps, bf16)
    case = "TSC_GRU_PROJ_CASE" if gates == 3 else "TSC_LSTM_PROJ_CASE"
    assert {int(u) for u in re.findall(rf"{case}\((\d+)\)", src)} == set(
        range(16, gp.CAP_U + 1, 16))


def test_tf32_fragment_maps_are_the_ptx_layout():
    """mma.m16n8k8 .tf32 (PTX ISA): b0 in row threadID_in_group, b1 four
    rows below, column groupID; each (row, column) of the 8 x 8 tile once."""
    seen = np.zeros((8, 8), int)
    for lane in range(32):
        g, tig = lane >> 2, lane % 4
        assert list(rp.B_ROW_TF32[lane]) == [tig, tig + 4]
        assert list(rp.B_COL_TF32[lane]) == [g, g]
        for i in range(2):
            seen[rp.B_ROW_TF32[lane, i], rp.B_COL_TF32[lane, i]] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cell,d_in,units", [("gru", 80, 48), ("lstm", 150, 48),
                                             ("gru", 65, 20), ("lstm", 97, 64)])
def test_projection_pack_round_trips(cell, d_in, units, dtype):
    """The pack's fragments back through their maps give W in the padded
    gate order (bf16: rounded to bf16; f32: hi a TF32 value, hi + lo W to
    2^-21 of each value), zero where padded and past D to a multiple of
    K_PAD rows."""
    gates = CELLS[cell][1]
    rng = np.random.default_rng(d_in)
    kernel = torch.tensor(rng.standard_normal((d_in, gates * units)),
                          dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal(gates * units), dtype=torch.float32)
    pack = rp.pack_projection(kernel, bias, units, DTYPES[dtype])
    u_p, k = gp.padded(units), rp.k_rows(d_in)
    assert pack.n_cols == gates * u_p and k % rp.K_PAD == 0
    want = rp.input_matrix(kernel, units, k)
    assert want.reshape(k, gates, u_p)[:d_in, :, :units].reshape(
        d_in, -1).equal(kernel)
    if dtype == "bfloat16":
        (w,) = rp.unpack_projection(pack)
        assert w.equal(want.to(torch.bfloat16).float())
    else:
        hi, lo = rp.unpack_projection(pack)
        assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
        assert ((hi + lo - want).abs() <= 2.0 ** -21 * want.abs()).all()
    b = pack.bias.reshape(gates, u_p)
    assert b[:, :units].equal(bias.reshape(gates, units))
    assert (b[:, units:] == 0).all()


def _from_tiles(xw, batch):
    """The kernel's XW layout back to (B, T, N): `rp.to_tiles` undone."""
    warps, steps, nt = xw.shape[:3]
    out = xw.new_zeros((warps, steps, gp.TILE, 8 * nt))
    r = torch.as_tensor(gp.C_ROW)
    c = 8 * torch.arange(nt)[:, None, None] + torch.as_tensor(gp.C_COL)
    out[:, :, r[None].expand_as(c), c] = xw
    return out.transpose(1, 2).reshape(warps * gp.TILE, steps, -1)[:batch]


def test_tiles_are_the_c_layout():
    """`to_tiles` puts window 16 w + C_ROW, column 8 n + C_COL at [w, t, n,
    lane, e]; `_from_tiles` undoes it; windows past B are zeros, or the
    fill (the plain version's bias, as the kernel writes it there)."""
    rows = torch.arange(B * T * 48, dtype=torch.float32).reshape(B, T, 48)
    tiles = rp.to_tiles(rows)
    assert tiles.shape == (2, T, 6, 32, 4)
    for lane in (0, 5, 31):
        for e in range(4):
            r, c = gp.C_ROW[lane, e], 8 * 3 + gp.C_COL[lane, e]
            assert tiles[0, 2, 3, lane, e] == rows[r, 2, c]
    assert _from_tiles(tiles, B).equal(rows)
    assert (_from_tiles(tiles, 32)[B:] == 0).all()
    fill = torch.arange(48, dtype=torch.float32)
    padded = _from_tiles(rp.to_tiles(rows, fill), 32)
    assert padded[:B].equal(rows) and (padded[B:] == fill).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_projection_emulation_meets_the_plain_version(dtype, x_dtype):
    """The kernel's arithmetic from its pack (W back through the maps; f32:
    three TF32 products) against `rnn_projection_plain`, in the layout."""
    cell = "lstm"
    layer = _model(cell, _variables(cell, 150, UNITS, 5), 150
                   ).backbone.lstm_unit_0
    x = torch.tensor(_features(150)).to(DTYPES[x_dtype])
    pack = rp.pack_projection(layer.kernel, layer.bias, UNITS, DTYPES[dtype])
    with torch.no_grad():
        got = rp.emulate(x, pack)
        want = rp.rnn_projection_plain(x, layer.kernel, layer.bias, UNITS,
                                       DTYPES[dtype])
        rows = x.float() @ layer.kernel + layer.bias
    assert got.shape == want.shape == (2, T, 4 * UNITS // 8, 32, 4)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(_from_tiles(want, B), rows, rtol=RTOL,
                                   atol=ATOL)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exact_projection_bounds_the_f32_sums(dtype):
    """`exact_projection`'s bound holds the plain version's f32 sums and the
    emulation's at D 600, and is not slack: under 1e-3 of the largest
    value's terms' magnitudes there."""
    rng = np.random.default_rng(6)
    d_in = 600
    kernel = torch.tensor(0.1 * rng.standard_normal((d_in, 3 * UNITS)),
                          dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal(3 * UNITS), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((B, T, d_in)), dtype=torch.float32)
    cd = DTYPES[dtype]
    exact, bound = rp.exact_projection(x, kernel, bias, UNITS, cd)
    plain = rp.rnn_projection_plain(x, kernel, bias, UNITS, cd)
    emulated = rp.emulate(x, rp.pack_projection(kernel, bias, UNITS, cd))
    for got in (plain, emulated):
        err = (got.double() - exact).abs()
        assert (err <= bound).all()
    assert (bound <= 1e-6 + 1e-3 * (x.abs().double() @ kernel.abs().double()
                                     ).max()).all()
    assert float((plain.double() - exact).abs().max()) > 0.0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("d_in", [80, 150])
def test_projected_route_meets_the_plain_module(d_in, cell, dtype):
    model = _model(cell, _variables(cell, d_in, UNITS, d_in), d_in)
    x = torch.tensor(_features(d_in))
    cd = DTYPES[dtype]
    with torch.no_grad():
        want = model(x, cd).numpy()
        got = _emulate(cell, model, x, cd).numpy()
        layer = model.backbone.cells()[0]
        emulated_xw = rp.emulate(x, _projected_pack(cell, layer,
                                                    cd).projection)
        got_emulated = _emulate(cell, model, x, cd, xw=emulated_xw).numpy()
    _close(got, want, dtype)
    _close(got_emulated, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("d_in", [80, 150])
def test_projected_route_meets_the_jax_kernel(d_in, cell, dtype):
    """The JAX kernel in interpret mode, as tests/test_torch_gru_plan.py
    runs it, one batch tile of all 19 windows."""
    variables = _variables(cell, d_in, UNITS, 100 + d_in)
    x = _features(d_in, seed=3)
    fused = make_fused_rnn_classifier(
        variables, cell_type=cell, n_features=T, feature_size=d_in,
        batch_tile=B, interpret=True, compute_dtype=getattr(jnp, dtype))
    want = np.asarray(fused(jnp.asarray(x)))
    model = _model(cell, variables, d_in)
    with torch.no_grad():
        got = _emulate(cell, model, torch.tensor(x), DTYPES[dtype]).numpy()
    _close(got, want, dtype)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_wrong_xw_layout_fails(cell):
    """The recurrence reads XW by the C layout: XW with rows g and g + 8 of
    each tile swapped takes the logits outside the f32 tolerance."""
    model = _model(cell, _variables(cell, 80, UNITS, 4), 80)
    x = torch.tensor(_features(80, batch=32))
    layer = model.backbone.cells()[0]
    with torch.no_grad():
        want = model(x, torch.float32)
        xw = rp.rnn_projection_plain(x, layer.kernel, _xw_bias(cell, layer),
                                     UNITS)
        right = _emulate(cell, model, x, torch.float32, xw=xw)
        wrong = _emulate(cell, model, x, torch.float32,
                         xw=xw[..., [2, 3, 0, 1]])
    tol = ATOL + RTOL * want.abs()
    assert ((right - want).abs() <= tol).all()
    assert ((wrong - want).abs() > tol).any()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_classifier_on_the_cpu_runs_the_plain_module(cell):
    """On the CPU a wide layer runs the plain module, and the raw wrappers
    refuse CPU tensors; a classifier packs nothing off the card."""
    model = _model(cell, _variables(cell, 300, UNITS, 2), 300)
    x = torch.tensor(_features(300))
    cls = (GRUClassifier if cell == "gru" else LSTMClassifier)(model)
    assert cls.packs == {}
    with torch.no_grad():
        torch.testing.assert_close(cls(x), model(x, torch.float32), rtol=0,
                                   atol=0)
    layer = model.backbone.cells()[0]
    pack = rp.pack_projection(layer.kernel, _xw_bias(cell, layer), UNITS)
    with pytest.raises(ValueError, match="CUDA"):
        rp.rnn_projection_cuda(x, pack)


def test_projection_ablation_variants_each_match_the_source_once():
    """dev/projection_ablation.py edits csrc/rnn_projection.cu by text: each
    text a variant replaces is in the source once, and each variant
    differs."""
    from tpu_speech_commands_torch.dev import projection_ablation

    sources = projection_ablation.variant_sources()
    assert set(sources) == {"base", *projection_ablation.CHOICES}
    assert len(set(sources.values())) == len(sources)
    assert "const int vec = 0;" in sources["registers"]
    assert "    S held[PER];" in sources["convert_at_load"]
    assert "kTwoBlockNtw = 0;" in sources["copy4"]
