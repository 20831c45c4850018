"""The projection kernel of the projected route (`csrc/rnn_projection_wgmma.cu`,
`wgmma` in both modes) on the CPU: its plan against the source's text, its
pack and the stage images TMA makes of it, its arithmetic from the pack
(`rnn_projection.emulate_wgmma`) against `exact_projection`'s bound, the
projected route through that emulation against the JAX kernel, and the
rule that sends some inputs to the first design (`csrc/rnn_projection.cu`,
`_mma_sync=True`).  The kernel itself against its plain version:
tests/test_torch_gpu.py.

Tolerances: the emulation within `exact_projection`'s bound of the float64
XW (an f32 sum of D products, plus 3xTF32's dropped terms in f32 mode);
the route's logits those of tests/test_torch_rnn_wide.py (f32 rtol 1e-4 /
atol 1e-5, bf16 atol 5e-2).
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_rnn_wide import (B, CELLS, DTYPES, T, UNITS, _c_function,
                                       _close, _emulate, _features, _model,
                                       _projected_pack, _source, _variables,
                                       _xw_bias)
from tpu_speech_commands.ops.pallas_rnn import make_fused_rnn_classifier
from tpu_speech_commands_torch.ops import gru_plan as gp
from tpu_speech_commands_torch.ops import rnn_projection as rp

SOURCE = "rnn_projection_wgmma.cu"
# the plan's one-return functions of the source
PLAN_FUNCTIONS = ("k_slice", "k_pad", "m64_tiles", "tile_rows",
                  "w_slice_bytes", "w_stage_bytes", "stage_bytes",
                  "resident_bytes", "fixed_bytes", "smem_bytes")


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def _source_plan():
    """The source's plan functions as Python, and its constants."""
    src = _source(SOURCE)
    env = {"kWideN": _define(src, "TSC_PJW_WIDE_N"),
           "kAPitch": _define(src, "TSC_PJW_APITCH"), "true": True,
           "false": False}
    fns = {name: _c_function(src, name) for name in PLAN_FUNCTIONS}
    for fn in fns.values():
        fn.__globals__.update(env, **fns)
    return src, fns


def test_the_wgmma_source_is_the_plan():
    """The source's #defines are the module's constants, and its widths
    the module's."""
    src = _source(SOURCE)
    for c_name, py in (("TSC_PJW_THREADS", rp.WG_THREADS),
                       ("TSC_PJW_APITCH", rp.A_PITCH),
                       ("TSC_PJW_MAX_STAGES", rp.WG_MAX_STAGES),
                       ("TSC_PJW_WIDE_N", rp.WIDE_N),
                       ("TSC_PJW_RESIDENT_STAGES", rp.RESIDENT_STAGES),
                       ("TSC_PJW_CLUSTER", rp.CLUSTER)):
        assert _define(src, c_name) == py, c_name
    assert int(re.search(r"constexpr int kSmemOptin = (\d+);", src).group(1)) \
        == gp.SMEM_OPTIN
    widths = re.search(r"#define TSC_PJW_WIDTHS\(X\) (.*)", src).group(1)
    assert tuple(int(n) for n in re.findall(r"X\((\d+)\)", widths)) == \
        rp.WG_WIDTHS
    # the widths are the first design's (N / 16 n-tiles a warp there)
    assert tuple(16 * n for n in rp.N_TILES_A_WARP) == rp.WG_WIDTHS
    for gates in (3, 4):
        for u_p in range(16, gp.CAP_U + 1, 16):
            assert gates * u_p in rp.WG_WIDTHS
    # the entry's resident rule is the plan's
    assert ("const int resident = bf16 ? ring_stages(true, true, kp, N) : 0;"
            in src and "const bool keep = resident >= kResidentStages;" in src)
    assert ("tsc_rnn_projection_wgmma(const void* x, int x_bf16, int batch, "
            "int T, int D,") in src


@pytest.mark.parametrize("d_in", [33, 80, 300, 600])
@pytest.mark.parametrize("bf16", [False, True])
def test_every_layout_fits(d_in, bf16):
    """At every N the kernel takes and D 33, 80, 300 and 600: the source's
    shared memory at the plan's stages is the plan's, under 232,448 bytes,
    with a ring of two stages or more (the most that fit, up to
    WG_MAX_STAGES; bf16 keeps W resident where RESIDENT_STAGES fit beside
    it); each cluster's half of W's rows is whole 8-row swizzle atoms and
    each K slice one 128-byte row."""
    _, fns = _source_plan()
    for n_cols in rp.WG_WIDTHS:
        plan = rp.wgmma_plan(n_cols, d_in, bf16)
        kp = fns["k_pad"](d_in, bf16)
        assert kp == plan.k_pad >= d_in and kp % fns["k_slice"](bf16) == 0

        def stages_at(resident):
            s = rp.WG_MAX_STAGES
            while s and fns["smem_bytes"](bf16, resident, kp, n_cols,
                                          s) > gp.SMEM_OPTIN:
                s -= 1
            return s

        resident = bf16 and stages_at(True) >= rp.RESIDENT_STAGES
        assert plan.resident == resident
        assert plan.stages == stages_at(resident) >= 2
        assert plan.smem_bytes == fns["smem_bytes"](
            bf16, resident, kp, n_cols, plan.stages) <= gp.SMEM_OPTIN
        assert plan.tile_rows == fns["tile_rows"](n_cols) in (128, 256)
        assert plan.cluster == (1 if resident else rp.CLUSTER)
        assert n_cols % 8 == 0 and n_cols <= 256  # a wgmma width
        assert (n_cols // plan.cluster) % 8 == 0
        assert fns["k_slice"](bf16) * (2 if bf16 else 4) == 128
        # the accumulators, n_cols / 2 floats a thread an m64 tile
        assert fns["m64_tiles"](n_cols) * n_cols // 2 <= 144


def test_w_l2_stream_below_the_features():
    """W's bytes from L2 at the timed shape (B 8192, T 23, D 300): f32, N
    144 (GRU) 135.7 MB against 226.1 MB of features (the first design's
    128-row blocks streamed 543 MB); bf16 W resident, 12.2 MB."""
    batch, steps, d_in = 8192, 23, 300
    features = batch * steps * d_in * 4
    assert rp.w_l2_bytes(batch, steps, d_in, 144, False) == 135_659_520
    first = -(-batch * steps // 128) * rp.k_rows(d_in) * 144 * 4 * 2
    assert first == 542_638_080
    assert rp.w_l2_bytes(batch, steps, d_in, 144, False) < features
    assert rp.w_l2_bytes(batch, steps, d_in, 144, True) == 132 * 320 * 144 * 2
    for n_cols in rp.WG_WIDTHS:
        assert rp.w_l2_bytes(batch, steps, d_in, n_cols, True) < features // 2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cell,d_in,units", [("gru", 80, 48), ("lstm", 150, 48),
                                             ("gru", 65, 20), ("lstm", 97, 64),
                                             ("gru", 33, 48)])
def test_wgmma_pack_round_trips(cell, d_in, units, dtype):
    """The kernel's tables are W transposed, K-major, (G U_p, k_pad): bf16
    W rounded, or f32 hi = tf32_rna(W) and lo = tf32_rna(W - hi); rows past
    D and padded units zero.  Read back through their stage images as the
    descriptors read them (`unpack_wgmma`), they give W in the padded gate
    order."""
    gates = CELLS[cell][1]
    rng = np.random.default_rng(d_in + units)
    kernel = torch.tensor(rng.standard_normal((d_in, gates * units)),
                          dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal(gates * units), dtype=torch.float32)
    pack = rp.pack_projection(kernel, bias, units, DTYPES[dtype])
    bf16 = dtype == "bfloat16"
    kp = rp.wgmma_k_pad(d_in, bf16)
    want = rp.input_matrix(kernel, units, kp)
    assert all(t.shape == (pack.n_cols, kp) and t.is_contiguous()
               for t in pack.tables)
    if bf16:
        (table,) = pack.tables
        assert table.dtype == torch.bfloat16
        assert table.float().equal(want.t().to(torch.bfloat16).float())
        (w,) = rp.unpack_wgmma(pack)
        assert w.equal(want.to(torch.bfloat16).float())
    else:
        hi_t, lo_t = pack.tables
        assert hi_t.equal(rp.tf32_rna(want.t()))
        assert lo_t.equal(rp.tf32_rna(want.t() - hi_t))
        hi, lo = rp.unpack_wgmma(pack)
        assert hi.equal(hi_t.t()) and lo.equal(lo_t.t())
        assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
        assert ((hi + lo - want).abs() <= 2.0 ** -21 * want.abs()).all()
    assert (want[d_in:] == 0).all()


def test_stage_images_are_the_128_byte_swizzle():
    """`stage_image`: row n's 16-byte chunk c of a K slice at chunk c ^ (n
    % 8), each row 128 bytes, in both element sizes."""
    for dtype, per in ((torch.float32, 32), (torch.bfloat16, 64)):
        n, kp = 24, 2 * per
        table = torch.arange(n * kp, dtype=torch.float32).reshape(n, kp).to(
            dtype)
        for kt in range(2):
            image = rp.stage_image(table, kt)
            assert image.shape == (n, per)
            chunk = per // 8
            for row in range(n):
                for c in range(8):
                    p = c ^ (row % 8)
                    assert image[row, p * chunk:(p + 1) * chunk].equal(
                        table[row, kt * per + c * chunk:
                              kt * per + (c + 1) * chunk])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d_in,gates,units", [(33, 3, 48), (80, 4, 48),
                                              (300, 3, 48), (150, 4, 64)])
def test_wgmma_emulation_meets_the_exact_bound(d_in, gates, units, dtype):
    """The kernel's arithmetic from its pack (k steps in order into f32
    accumulators started from the bias; f32: three TF32 products a step)
    within `exact_projection`'s bound of the float64 XW, B 19 (a ragged
    second tile: its windows hold the bias)."""
    rng = np.random.default_rng(d_in)
    kernel = torch.tensor(rng.standard_normal((d_in, gates * units))
                          / np.sqrt(d_in), dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal(gates * units), dtype=torch.float32)
    cd = DTYPES[dtype]
    x = torch.tensor(rng.standard_normal((B, T, d_in)),
                     dtype=torch.float32).to(cd)
    pack = rp.pack_projection(kernel, bias, units, cd)
    got = rp.emulate_wgmma(x, pack)
    exact, bound = rp.exact_projection(x, kernel, bias, units, cd)
    assert got.shape == exact.shape == (2, T, gates * gp.padded(units) // 8,
                                        32, 4)
    assert torch.isfinite(got).all()
    assert ((got.double() - exact).abs() <= bound).all()
    torch.testing.assert_close(got, rp.emulate(x, pack), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("d_in", [80, 300])
def test_projected_route_through_the_kernel_meets_the_jax_kernel(d_in, cell,
                                                                 dtype):
    """XW from the kernel's emulation, then the tile kernel's warps in
    projected mode, against the JAX kernel in interpret mode, as
    tests/test_torch_rnn_wide.py's test_projected_route_meets_the_jax_kernel
    runs it, one batch tile of all 19 windows."""
    variables = _variables(cell, d_in, UNITS, 200 + d_in)
    x = _features(d_in, seed=5)
    fused = make_fused_rnn_classifier(
        variables, cell_type=cell, n_features=T, feature_size=d_in,
        batch_tile=B, interpret=True, compute_dtype=getattr(jnp, dtype))
    want = np.asarray(fused(jnp.asarray(x)))
    model = _model(cell, variables, d_in)
    cd = DTYPES[dtype]
    xt = torch.tensor(x).to(cd)
    with torch.no_grad():
        layer = model.backbone.cells()[0]
        xw = rp.emulate_wgmma(xt, _projected_pack(cell, layer, cd).projection)
        got = _emulate(cell, model, xt, cd, xw=xw).numpy()
    _close(got, want, dtype)


def test_projection_design_is_the_rule():
    """The rule on the mode: the kernel in f32 mode, the first design in
    bf16 mode (whose pack is built with the tables; f32 mode builds it at
    its first use); `_mma_sync` True or False forces either.  The kernel
    takes x in the other type than the mode's converted to it (f32 features
    in bf16 mode rounded to bf16), so its arithmetic there is that on the
    converted x."""
    layer = _model("gru", _variables("gru", 80, UNITS, 9), 80
                   ).backbone.cells()[0]
    packs = {name: rp.pack_projection(layer.kernel, _xw_bias("gru", layer),
                                      UNITS, cd) for name, cd in DTYPES.items()}
    assert rp.WGMMA_MODES == (torch.float32,)
    for name, pack in packs.items():
        default = "wgmma" if name == "float32" else "mma_sync"
        assert rp.projection_design(pack) == default
        assert rp.projection_design(pack, _mma_sync=True) == "mma_sync"
        assert rp.projection_design(pack, _mma_sync=False) == "wgmma"
        # the first design's pack: built with the tables where it runs by
        # default, else not yet
        assert ("weights" in vars(pack)) == (default == "mma_sync")
    # the kernel's arithmetic on x in the other type: that on x converted
    # to the mode's type, as the wrapper converts it
    x = torch.tensor(np.random.default_rng(3).standard_normal((4, T, 80)),
                     dtype=torch.float32)
    pack = packs["bfloat16"]
    torch.testing.assert_close(rp.emulate_wgmma(x, pack), rp.emulate_wgmma(
        x.to(torch.bfloat16), pack), rtol=0, atol=0)


def test_projection_ablation_cuts_each_match_the_source_once():
    """dev/projection_ablation.py's cuts of the kernel edit its switch's
    default once each, and its cluster variant the cluster's."""
    from tpu_speech_commands_torch.dev import projection_ablation

    sources = projection_ablation.cut_sources()
    assert set(sources) == {"base", *projection_ablation.CUTS}
    assert len(set(sources.values())) == len(sources)
    for name, n in projection_ablation.CUTS.items():
        if n is not None:
            assert f"#define TSC_PJW_CUT {n}\n" in sources[name]
    assert "#define TSC_PJW_CLUSTER 1 " in sources["no_cluster"]
    plans = projection_ablation.plan_sources()
    assert set(plans) == {"base", *projection_ablation.VARIANTS}
    assert len(set(plans.values())) == len(plans)
