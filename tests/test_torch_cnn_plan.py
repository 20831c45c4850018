"""The plan of the tiled implicit-GEMM CNN classifier kernel
(`ops/cnn_plan.py`), on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py holds it to the
plain version there).  Here, for both models, the three shapes the kernel
takes (30 x 20, the `use_delta` 30 x 40 whose block 3 pads 0 low and 1
high, and the odd 29 x 21 whose VALID pools drop a row and a column) and
both compute dtypes:
- the plan's tile and shared memory fit a block's 232,448 bytes, and every
  input shape whose window the SIMT kernel's shared memory took has a plan;
- the weight ring streams the lowered HWIO kernels, chunk by chunk at the
  slot's pitch, exactly, in the order the products read them;
- every tap that falls on the SAME padding reads the zero row, and every
  other tap the pixel F.pad would put there;
- the CPU emulation, which runs the plan's blocks in a flat shared memory
  (NaN where nothing was stored) with the ring, the rounds and the taps at
  the plan's offsets and pitches, meets `cnn_classifier_plain`: f32 at atol
  1e-4 / rtol 1e-5 (another summation order over K <= 576), bf16 at atol
  5e-2 (a bf16 rounding of an activation can flip when two f32 sums differ
  in the last bit; the bound tests/test_serving.py allows); and a plan with
  one number wrong does not;
- at a small shape (16 x 16), the emulation meets the JAX kernel
  (`make_fused_cnn_classifier`, interpret mode) at those tolerances, with
  rtol 1e-4 / atol 1e-5 in f32 as tests/test_torch_cnn.py holds the plain
  version to it.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tpu_speech_commands.models import get_model as jax_get_model
from tpu_speech_commands.ops import pallas_classifier
from tpu_speech_commands_torch.models.cnn import SimpleCNN, SimpleCNNLite
from tpu_speech_commands_torch.ops import _build
from tpu_speech_commands_torch.ops import cnn_plan as cp
from tpu_speech_commands_torch.ops.cnn_kernel import (ClassifierTensors,
                                                      cnn_classifier_plain)
from tpu_speech_commands_torch.ops.cnn_lowering import lower_classifier

MODELS = {"simple_cnn": SimpleCNN, "simple_cnn_lite": SimpleCNNLite}
SHAPES = [(30, 20), (30, 40), (29, 21)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_ATOL = 5e-2


def _random_model(model_type, h, w, seed):
    """A model with weights and BatchNorm statistics from a numpy seed; some
    BatchNorm scales negative, as after training."""
    model = MODELS[model_type](5, h, w)
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
    return model.eval()


def _lowered(model_type, shape):
    model = _random_model(model_type, *shape, seed=sum(shape))
    return model, lower_classifier(model.variables(), model.separable, *shape)


def _features(shape, seed, batch=19):
    """19 windows: three f32 blocks of 8 at 30 x 20, two bf16 ones of 16,
    the last ragged."""
    return torch.tensor(4.0 * np.random.default_rng(seed).standard_normal(
        (batch,) + shape), dtype=torch.float32)


def _check(got, want, dtype):
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=BF16_ATOL)


CASES = [(m, s, d) for m in MODELS for s in SHAPES for d in DTYPES]


@pytest.mark.parametrize("model_type,shape,dtype", CASES)
def test_plan_fits_a_block(model_type, shape, dtype):
    _, low = _lowered(model_type, shape)
    cd = DTYPES[dtype]
    plan = cp.make_plan(low.stages, 128, cd)
    assert 1 <= plan.tile <= cp.MAX_TILE[cd]
    assert plan.smem_bytes <= cp.SMEM_OPTIN == 232448
    # these shapes take the padded layout and the deep ring
    assert plan.ring == cp.RING[cd] and plan.out_pitch1 == cp.pitch(16, cd)
    assert plan.slot_bytes >= cp.MIN_SLOT_BYTES[cd]
    # the slots take what the tile leaves: less than a slot's 16 bytes each
    assert cp.SMEM_OPTIN - plan.smem_bytes < 16 * plan.ring
    # one window more does not fit beside the least ring, unless the tile
    # is at its cap
    if plan.tile < cp.MAX_TILE[cd]:
        assert plan.ring_off + plan.ring * cp.MIN_SLOT_BYTES[cd] + \
            (plan.tile + 1) * (plan.a_wpitch + plan.b_wpitch) * plan.elem > \
            cp.SMEM_OPTIN
    for off in (plan.ring_off, plan.a_off, plan.b_off, plan.slot_bytes):
        assert off % 16 == 0
    assert plan.a_wpitch % 8 == 0 and plan.b_wpitch % 8 == 0
    vec = cp.vec_elems(cd)
    for prod in plan.products:
        assert prod.in_pitch % vec == 0 and prod.out_pitch % vec == 0
        assert prod.k % cp.MMA_K == 0 and prod.kc % cp.K_STEP[cd] == 0
        assert prod.chunks * prod.kc >= prod.k > (prod.chunks - 1) * prod.kc
        # a chunk of weight rows fits its slot at the slot's row pitch
        assert prod.kc * (prod.n + vec) * plan.elem <= plan.slot_bytes
        assert plan.zero_elems >= prod.cin or prod.name == "dense"
    assert len(plan.ints()) == len(cp.HEADER) + 4 * len(cp.STAGE_INTS)
    # the tile's rows, split over the warps (bf16) or threads (f32), take
    # the plan's rounds
    for prod in plan.products:
        rows = plan.tile * prod.rows
        if dtype == "bfloat16":
            items = -(-rows // 16) * (prod.n // prod.unit)
            assert prod.n % prod.unit == 0
            assert prod.rounds == -(-items // cp.WARPS)
        else:
            assert prod.unit == 4 if prod.quads == 4 else prod.unit in (1, 2, 4)
            assert prod.cols in (4, 8)
            items = -(-rows // prod.unit) * (prod.n // prod.cols)
            assert prod.rounds == -(-items // cp.THREADS)


def test_default_tiles_reuse_weights_over_many_windows():
    """At 30 x 20 a bf16 block takes up to 16 windows; an f32 block up to 8
    (12 would fit, but its activations take twice the bytes and leave the
    ring slots of a sixteenth of a stage), whose slots then hold stage 2's
    weights whole and stage 4's in 10 chunks."""
    _, low = _lowered("simple_cnn", (30, 20))
    bf16 = cp.make_plan(low.stages, 128, torch.bfloat16)
    f32 = cp.make_plan(low.stages, 128, torch.float32)
    assert (bf16.tile, f32.tile) == (16, 8)
    assert f32.products[0].chunks == 1 and f32.products[2].chunks == 10
    with pytest.raises(ValueError, match="takes 1 to 8"):
        cp.make_plan(low.stages, 128, torch.float32, 9)
    # a smaller tile leaves the ring more room
    assert cp.make_plan(low.stages, 128, torch.bfloat16, 4).slot_bytes > \
        bf16.slot_bytes


def _simt_smem_bytes(stages, hidden):
    """The shared memory tsc_cnn_classifier_simt takes at a tile of one
    window: f32 activations at an odd pitch (c + 1) in two buffers, the
    second also holding the dense layer's partial sums."""
    sizes = [stages[0].h_in * stages[0].w_in, 0]
    for k, st in enumerate(stages):
        i = (k + 1) % 2
        sizes[i] = max(sizes[i], st.h_out * st.w_out * (st.cout + 1))
    slices = max(512 // hidden, 1)
    i = (len(stages) % 2) ^ 1
    sizes[i] = max(sizes[i], slices * hidden)
    return 4 * (sizes[0] + sizes[1])


@functools.cache
def _stages(h, w):
    return lower_classifier(SimpleCNN(5, h, w).variables(), False, h, w).stages


@pytest.mark.parametrize("w", [20, 40, 61, 80])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_shape_the_simt_kernel_took_has_a_plan(dtype, w):
    """H from 16 up, past the last the SIMT kernel's shared memory takes:
    each shape it took has a plan (the larger ones with unpadded pixels and
    a ring of 2 slots).  198 x 40 (2 s windows at a 10 ms hop with deltas)
    is one of them."""
    cd = DTYPES[dtype]
    fallbacks = 0
    for h in range(16, 2000, 3):
        stages = _stages(h, w)
        if _simt_smem_bytes(stages, 128) > cp.SMEM_OPTIN:
            break
        plan = cp.make_plan(stages, 128, cd)
        assert plan.smem_bytes <= cp.SMEM_OPTIN
        fallbacks += plan.ring == 2
    else:
        pytest.fail("no shape past the SIMT kernel's shared memory")
    assert h > 60
    if dtype == "float32":  # the last shapes needed the fallback
        assert fallbacks > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_window_too_large_for_the_deep_ring_takes_the_fallback(dtype):
    """198 x 40: in f32 the padded window (228,960 bytes) leaves no room
    for 3 slots, so the plan takes pitch c and 2 slots; the emulation of
    that plan meets the plain version."""
    cd = DTYPES[dtype]
    model, low = _lowered("simple_cnn", (198, 40))
    plan = cp.make_plan(low.stages, 128, cd)
    assert plan.tile == 1 and plan.smem_bytes <= cp.SMEM_OPTIN
    if cd == torch.float32:
        assert plan.ring == 2 and plan.out_pitch1 == 16
        assert [p.in_pitch for p in plan.products] == [16, 32, 64, 128]
    else:
        assert plan.ring == cp.RING[cd] and plan.out_pitch1 == 24
    x = _features((198, 40), seed=5, batch=2)
    _check(cp.emulate(low, plan, x),
           cnn_classifier_plain(ClassifierTensors(low, "cpu", cd), x), cd)


def _mats(low, dtype):
    return [cp._store(torch.tensor(a).reshape(-1, a.shape[-1]), dtype)
            for a in [st.kernel for st in low.stages[1:]] + [low.dense_w]]


@pytest.mark.parametrize("model_type,shape,dtype", CASES)
def test_the_ring_streams_the_lowered_kernels_exactly(model_type, shape, dtype):
    """Each step's slot, read at the slot's row pitch, holds the next chunk
    of the product being read: the HWIO kernel as the (9 cin, cout) K-major
    matrix (no row padded, the weights in the compute type), stage by stage,
    again each round where a product takes several chunks."""
    _, low = _lowered(model_type, shape)
    cd = DTYPES[dtype]
    plan = cp.make_plan(low.stages, 128, cd)
    mem = torch.full((plan.smem_bytes // plan.elem,), float("nan"))
    mats = _mats(low, cd)
    ring = cp.Ring(plan, mats, mem)
    for st, m in zip(low.stages[1:], mats):
        assert m.shape == (9 * st.cin, st.cout)
        np.testing.assert_array_equal(
            m.reshape(3, 3, st.cin, st.cout).numpy(),
            torch.tensor(st.kernel).to(cd).float().numpy())
    for prod, m in zip(plan.products, mats):
        pn = prod.n + cp.vec_elems(cd)
        for _ in range(1 if prod.chunks == 1 else prod.rounds):
            got = []
            for c in range(prod.chunks):
                base = ring.step()
                rows = min(prod.kc, prod.k - c * prod.kc)
                got.append(mem[base + torch.arange(rows)[:, None] * pn
                               + torch.arange(prod.n)])
            assert torch.equal(torch.cat(got), m)
    assert ring.loaded >= len(ring.stream)


@pytest.mark.parametrize("model_type", sorted(MODELS))
@pytest.mark.parametrize("shape", SHAPES)
def test_padding_taps_read_the_zero_row(model_type, shape):
    """Each row's nine taps (`tap_pixels`, what the kernel's row_ref /
    tap_off read) against F.pad of the pixel indices (fill -1) with the
    stage's TF SAME pads, at the row's conv position: row (w P + p) Q + q,
    q = 2 qy + qx the pool's quad."""
    _, low = _lowered(model_type, shape)
    plan = cp.make_plan(low.stages, 128, torch.bfloat16)
    for st, prod in zip(low.stages[1:], plan.products):
        (top, bottom), (left, right) = st.pads
        idx = torch.arange(st.h_in * st.w_in, dtype=torch.float64).view(
            1, 1, st.h_in, st.w_in)
        padded = F.pad(idx, (left, right, top, bottom), value=-1.0)[0, 0]
        rows = torch.arange(2 * prod.rows)  # two windows
        table = cp.tap_pixels(prod, st, rows)
        assert table.shape == (len(rows), 9)
        for r, row in zip(rows.tolist(), table):
            p, q = divmod(r % prod.rows, prod.quads)
            py, px = divmod(p, st.w_out)
            cy, cx = ((2 * py + q // 2, 2 * px + q % 2) if st.pool
                      else (py, px))
            y, x = cy * st.stride, cx * st.stride
            want = padded[y:y + 3, x:x + 3].reshape(-1).to(torch.int64)
            assert torch.equal(row, want)
        pads = sum(st.pads[0]) + sum(st.pads[1])
        assert bool((table < 0).any()) == (pads > 0)


@pytest.mark.parametrize("model_type", sorted(MODELS))
@pytest.mark.parametrize("shape", SHAPES)
def test_rows_keep_a_pooled_positions_quads_adjacent(model_type, shape):
    """Rows 4 p .. 4 p + 3 of a pooled stage read the four 3 x 3 patches
    whose conv outputs pool into output position p: their centre taps are
    the 2 x 2 block at (2 py, 2 px); the VALID pool's dropped positions
    are no rows.  The dense layer's row is its window."""
    _, low = _lowered(model_type, shape)
    plan = cp.make_plan(low.stages, 128, torch.float32)
    for st, prod in zip(low.stages[1:], plan.products):
        assert prod.rows == st.h_out * st.w_out * (4 if st.pool else 1)
        if not st.pool:
            continue
        (pad_h, _), (pad_w, _) = st.pads
        centre = cp.tap_pixels(prod, st, torch.arange(prod.rows))[:, 4]
        for p in range(st.h_out * st.w_out):
            py, px = divmod(p, st.w_out)
            want = sorted((2 * py + dy - pad_h + 1) * st.w_in
                          + 2 * px + dx - pad_w + 1
                          for dy in (0, 1) for dx in (0, 1))
            assert sorted(centre[4 * p:4 * p + 4].tolist()) == want
    dense = plan.products[-1]
    win, p, q = cp.conv_positions(dense, torch.arange(5))
    assert win.tolist() == list(range(5)) and not p.any() and not q.any()


@pytest.mark.parametrize("model_type,shape,dtype", CASES)
def test_emulation_meets_the_plain_version(model_type, shape, dtype):
    model, low = _lowered(model_type, shape)
    cd = DTYPES[dtype]
    consts = ClassifierTensors(low, "cpu", cd)
    x = _features(shape, seed=3)
    got = cp.emulate(low, consts.plan, x)
    assert got.shape == (19, 5)
    _check(got, cnn_classifier_plain(consts, x), cd)
    if cd == torch.float32:
        with torch.no_grad():
            torch.testing.assert_close(got, model(x), rtol=1e-5, atol=1e-4)


def _wrong(plan, field, product=None, delta=0):
    """The plan with one number moved by `delta`."""
    if product is None:
        return dataclasses.replace(plan, **{field: getattr(plan, field) + delta})
    prods = list(plan.products)
    prods[product] = dataclasses.replace(
        prods[product], **{field: getattr(prods[product], field) + delta})
    return dataclasses.replace(plan, products=tuple(prods))


MUTATIONS = {
    "a round short": ("rounds", 0, -1),
    "a chunk short of stage 4's K": ("chunks", 2, -1),
    "a chunk's rows short of the dense layer's K": ("kc", 3, "-half"),
    "windows overlapping in A": ("a_wpitch", None, -64),
    "a zero row shorter than cin": ("zero_elems", None, -48),
    "stage 3 reading at the wrong pitch": ("in_pitch", 1, "+vec"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_wrong_plan_fails_the_emulation(dtype, mutation):
    """The emulation reads the plan: one number of the 30 x 20 plan moved
    gives NaN (memory where nothing was stored), an index outside the
    block, or logits more than 1e-3 off those of the right plan (in f32 also
    off the plain version by more than the tolerance)."""
    _, low = _lowered("simple_cnn", (30, 20))
    cd = DTYPES[dtype]
    consts = ClassifierTensors(low, "cpu", cd)
    field, product, delta = MUTATIONS[mutation]
    if delta == "-half":
        delta = -(consts.plan.products[product].kc // 2)
    elif delta == "+vec":
        delta = cp.vec_elems(cd)
    x = _features((30, 20), seed=3)
    right = cp.emulate(low, consts.plan, x)
    try:
        got = cp.emulate(low, _wrong(consts.plan, field, product, delta), x)
    except IndexError:
        return
    if torch.isfinite(got).all():
        assert (got - right).abs().max() > 1e-3
        if cd == torch.float32:
            want = cnn_classifier_plain(consts, x)
            assert (got - want).abs().max() > 1e-4 + 1e-5 * want.abs().max()


@pytest.mark.parametrize("model_type", sorted(MODELS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_emulation_meets_the_jax_kernel(model_type, dtype):
    """16 x 16 features, flax's own init with BatchNorm statistics from a
    seed; the JAX kernel in interpret mode, as tests/test_torch_cnn.py runs
    it."""
    h = w = 16
    rng = np.random.default_rng(11)
    jmodel = jax_get_model(model_type, 5)
    variables = jmodel.init({"params": jax.random.PRNGKey(3)},
                            jnp.zeros((2, h, w, 1), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    stats = {
        name: {"bn": {"mean": rng.normal(0.0, 0.5, s["bn"]["mean"].shape)
                      .astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, s["bn"]["var"].shape)
                      .astype(np.float32)}}
        for name, s in variables["batch_stats"].items()}
    variables = {"params": variables["params"], "batch_stats": stats}
    x = (3.0 * rng.standard_normal((6, h, w))).astype(np.float32)
    fused = pallas_classifier.make_fused_cnn_classifier(
        variables, separable=jmodel.separable, n_features=h, feature_size=w,
        batch_tile=2, interpret=True, compute_dtype=getattr(jnp, dtype))
    want = np.asarray(fused(jnp.asarray(x)))
    low = lower_classifier(variables, jmodel.separable, h, w)
    plan = cp.make_plan(low.stages, 128, DTYPES[dtype])
    got = cp.emulate(low, plan, torch.tensor(x)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


def test_a_config_too_large_for_a_block_is_refused():
    """One 200 x 200 window's activations exceed a block's shared memory,
    even unpadded beside 2 slots: ValueError, by config (the plain version
    still takes it; so would not the SIMT kernel)."""
    _, low = _lowered("simple_cnn", (200, 200))
    assert _simt_smem_bytes(low.stages, 128) > cp.SMEM_OPTIN
    for dtype in DTYPES.values():
        with pytest.raises(ValueError, match="shared memory"):
            cp.make_plan(low.stages, 128, dtype)
    consts = ClassifierTensors(low, "cpu")
    assert cnn_classifier_plain(consts, _features((200, 200), 1, 2)).shape == (2, 5)


def test_the_cuda_source_reads_the_plan_as_the_plan_writes_it():
    """csrc/cnn_classifier.cu and the plan describe one layout: the header
    and product lengths, the block's threads, the ring depths it takes."""
    src = (_build.CSRC_DIR / "cnn_classifier.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kPlanHeader") == len(cp.HEADER)
    assert const("kPlanProduct") == len(cp.STAGE_INTS)
    assert const("kGemmThreads") == cp.THREADS
    depth = re.search(r"return sizeof\(CT\) == 2 \? (\d+) : (\d+);", src)
    assert (int(depth.group(1)), int(depth.group(2))) == (
        cp.RING[torch.bfloat16], cp.RING[torch.float32])
    assert const("kFallbackRing") == cp.FALLBACK_RING
    # the entry point's comment names the header and product fields in order
    doc = src[src.index("// The tiled implicit-GEMM classifier"):
              src.index('extern "C" int tsc_cnn_classifier(')]
    doc = " ".join(line.lstrip("/ ") for line in doc.splitlines())
    assert "(" + ", ".join(cp.HEADER) + ")" in doc
    assert "(" + ", ".join(cp.STAGE_INTS) + ")" in doc


def test_ablation_cuts_each_match_the_kernel_source_once():
    """dev/cnn_ablation.py edits csrc/cnn_classifier.cu by text: each text a
    cut replaces is in the source once, and each cut differs.  The per-block
    slab cuts leave every other stage's inner loop as shipped: the slab read
    sits behind a template flag that only that stage's instantiation sets."""
    from tpu_speech_commands_torch.dev import cnn_ablation

    sources = cnn_ablation.variant_sources()
    assert set(sources) == {"base", *cnn_ablation.CUTS, *cnn_ablation.GEMM_CUTS}
    assert len(set(sources.values())) == len(sources)
    for name, stage in (("block4_l1", 3), ("block3_l1", 2)):
        src = sources[name]
        assert "bool kSlab = false>" in src and "load4(kSlab ? " in src
        assert src.count("kBf16, true>") == 2
        assert f"if (k == {stage} && s.pool)" in src
