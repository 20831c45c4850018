"""The CNN block-1 kernel (`csrc/cnn_block1.cu`) emulated on the CPU through
its plan (`ops/block1_plan.py`): the source's constants and shared memory
against the plan, the route a config gets, and one launch's data moved by
each of the kernel's maps (the ring's stages filled as the producer fills
them, x at aligned and unaligned addresses; the warps' chunks; the items'
fast division; the patch and its padding; the channel groups, the warp's
output buffer and its read-back; in bf16 the tensor-core fragments, the
pool's shuffle and the stored channels) against `cnn_block1_plain`.

Tolerance: rtol / atol 1e-5, f32 and bf16 alike: the same products summed
in another order (in bf16 mode the products of bf16 values are exact in
f32).  The CUDA kernel against the plain version on the card:
test_torch_gpu.py.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from tpu_speech_commands_torch.ops import _build, block1_plan, cnn_kernel
from tpu_speech_commands_torch.ops.cnn_lowering import Stage

SRC = (_build.CSRC_DIR / "cnn_block1.cu").read_text()
CNN_SHAPES = [(30, 20), (30, 40), (29, 21)]


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _define(name):
    return re.search(rf"#ifndef {name}\n#define {name} (.+)\n#endif", SRC).group(1)


def _stage(h, w, compute_dtype, seed=0):
    rng = np.random.default_rng(seed)
    st = Stage(rng.standard_normal((3, 3, 1, 16)).astype(np.float32),
               rng.standard_normal(16).astype(np.float32), None, None, h, w, 1,
               True)
    return cnn_kernel.StageTensors(st, "cpu", compute_dtype)


def _emulate(stage, x, **kw):
    return block1_plan.emulate(
        x.float().numpy(), stage.kernel.float().numpy(), stage.bias.numpy(),
        stage.compute_dtype == torch.bfloat16,
        bf16_in=x.dtype == torch.bfloat16, **kw)


def test_source_constants_are_the_plan():
    """Warps, chunk, taps, channels, slack and the shared-memory limit, and
    the ablation switches' defaults, read out of the source."""
    p = block1_plan
    assert (_const("kCout"), _const("kTaps"), _const("kConsumerWarps"),
            _const("kSlack")) == (p.COUT, p.TAPS, p.CONSUMER_WARPS, p.SLACK)
    assert "constexpr int kChunk = 32 * kItems;" in SRC
    assert p.CHUNK == 32 * p.ITEMS
    assert int(_define("TSC_B1_ITEMS")) == p.ITEMS
    assert f"constexpr size_t kSmemLimit = {p.SMEM_LIMIT};" in SRC
    assert int(_define("TSC_B1_STAGES")) == p.STAGES
    assert int(_define("TSC_B1_TILE")) == p.MAX_TILE
    assert "constexpr int kStageBudget = kMaxTile * 2560;" in SRC
    assert p.STAGE_BUDGET == p.MAX_TILE * 2560
    assert int(_define("TSC_B1_BLOCKS")) == p.BLOCKS_PER_SM
    assert int(_define("TSC_B1_STORE")) == p.STORE
    assert int(_define("TSC_B1_MMA")) == p.MMA
    assert int(_define("TSC_B1_CUT")) == 0
    assert "__launch_bounds__(kThreads, kBlocksPerSm)" in SRC
    assert "constexpr int kThreads = 32 * (kConsumerWarps + 1);" in SRC


def test_source_shared_memory_is_the_mirror():
    """The source's layout terms, in the plan's order."""
    assert ("constexpr int kWeightBytes = (kTaps + 1) * kCout * 4;" in SRC
            and "constexpr int kBarrierOff = kWeightBytes;" in SRC)
    assert ("constexpr int kRingOff = (kBarrierOff + 16 * kStages + 127) / "
            "128 * 128;") in SRC
    assert "return ((size_t)tile * window_bytes + 15) / 16 * 16 + kSlack;" in SRC
    assert "return kRingOff + kStages * stage_bytes(tile, window_bytes);" in SRC
    assert ("(kStore >= 2 ? (size_t)kConsumerWarps * kOutBuffers * "
            "kChunkBytes : 0)") in SRC
    assert "constexpr int kOutBuffers = kStore == 3 ? 2 : 1;" in SRC
    assert "return t < 1 ? 1 : (t > kMaxTile ? kMaxTile : t);" in SRC
    # 30 x 20 f32: 8 windows a tile, 91,232 bytes: two blocks an SM fit
    assert block1_plan.tile_windows(2400) == 8
    assert block1_plan.smem_bytes(8, 2400) == 768 + 3 * 19232 + 8 * 4096
    assert 2 * block1_plan.smem_bytes(8, 2400) <= 228 * 1024


@pytest.mark.parametrize("hw, elem, want", [
    ((30, 20), 4, "cnn_block1"), ((30, 20), 2, "cnn_block1"),
    ((198, 40), 4, "cnn_block1"), ((100, 100), 4, "cnn_block1"),
    ((200, 200), 4, "cnn_block1_simt"), ((200, 200), 2, "cnn_block1_simt"),
])
def test_kernel_for_chooses_from_the_config(hw, elem, want):
    """A window whose ring does not fit a block's shared memory takes the
    SIMT kernel, chosen before any launch; the wrapper names the same."""
    assert block1_plan.kernel_for(*hw, elem) == want
    stage = _stage(*hw, torch.float32)
    dtype = torch.float32 if elem == 4 else torch.bfloat16
    assert cnn_kernel.block1_kernel_for(stage, dtype) == want


def test_fast_division_is_exact_where_the_kernel_uses_it():
    """(n * ceil(2^32 / d)) >> 32 == n // d for every n of a tile's items
    and every divisor the shapes above give, and at the launch's guard."""
    n = np.arange(1 << 15)
    for d in list(range(1, 200)) + [14400, 32767]:
        lim = n[n * d < (1 << 32)]
        np.testing.assert_array_equal(
            block1_plan.fast_div(lim, block1_plan.div_magic(d)), lim // d)
    assert "if ((uint64_t)a.tile * a.n_pos * a.n_pos >= (1ull << 32))" in SRC
    win, oy, ox = block1_plan.item_coords(np.arange(8 * 150), 150, 10)
    np.testing.assert_array_equal(win, np.arange(1200) // 150)
    np.testing.assert_array_equal(oy * 10 + ox, np.arange(1200) % 150)


@pytest.mark.parametrize("chunks", [[38, 38, 38, 38], [3, 38, 5], [1], [7, 9]])
def test_warps_take_every_chunk_once(chunks):
    """Warp w takes chunks w, w + 8, ... across the block's tiles: each
    chunk once, in order within a warp."""
    got = block1_plan.warp_chunks(chunks)
    assert sorted((k, c) for _, k, c in got) == [
        (k, c) for k, n in enumerate(chunks) for c in range(n)]
    for w in range(block1_plan.CONSUMER_WARPS):
        mine = [(k, c) for ww, k, c in got if ww == w]
        assert mine == sorted(mine)


@pytest.mark.parametrize("offset, window_bytes, elem", [
    (offset, wb, elem) for wb, elem in ((2400, 4), (2436, 4), (1218, 2))
    for offset in (0, 2, 4, 6, 8, 14) if offset % elem == 0])
def test_stage_fill_copies_each_byte_of_the_tile(offset, window_bytes, elem):
    """The bulk copy's range is 16-byte aligned and a multiple of 16, the
    plain elements fill the rest, and the stage holds the tile's bytes at
    its shift."""
    batch = 24
    x = np.arange(batch * window_bytes, dtype=np.int64).astype(np.uint8)
    tile = block1_plan.tile_windows(window_bytes)
    for fw, nb in block1_plan.block_tiles(1, 2, batch, tile):
        stage, shift, bulk = block1_plan.stage_fill(
            x, 4096 + offset, tile, fw, nb, window_bytes, elem)
        assert shift == (offset + fw * window_bytes) % 16
        assert bulk % 16 == 0 and bulk > nb * window_bytes - 32
        lo = fw * window_bytes
        np.testing.assert_array_equal(
            stage[shift:shift + nb * window_bytes],
            x[lo:lo + nb * window_bytes])


@pytest.mark.parametrize("batch, slots", [(8192, 264), (13, 2), (5, 8), (37, 3)])
def test_blocks_split_the_batch_evenly(batch, slots):
    """The persistent grid's blocks (one a window at most) take each window
    once, at most one more than another, in tiles of at most the plan's
    tile."""
    tile = block1_plan.tile_windows(2400)
    grid = min(batch, slots)
    per_block = [block1_plan.block_tiles(b, grid, batch, tile)
                 for b in range(grid)]
    windows = [fw + i for tiles in per_block for fw, nb in tiles
               for i in range(nb)]
    assert windows == list(range(batch))
    assert all(0 < nb <= tile for tiles in per_block for _, nb in tiles)
    counts = [sum(nb for _, nb in tiles) for tiles in per_block]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1
    assert "return (int)((int64_t)(b + 1) * a.batch / gridDim.x);" in SRC
    assert "const int grid = a.batch < per_sm * sms ? a.batch : per_sm * sms;" in SRC


@pytest.mark.parametrize("shape", CNN_SHAPES)
@pytest.mark.parametrize("compute_dtype, x_dtype, tensor", [
    (torch.float32, torch.float32, False),
    (torch.float32, torch.bfloat16, False),
    (torch.bfloat16, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, False),
    (torch.bfloat16, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, True),
])
def test_emulation_matches_plain(shape, compute_dtype, x_dtype, tensor):
    """13 windows (a ragged last tile), x placed 4 bytes past a 16-byte
    boundary (2 for bf16 features), a grid of 2 blocks: the emulation of
    every map equals the plain version."""
    stage = _stage(*shape, compute_dtype, seed=sum(shape))
    rng = np.random.default_rng(3)
    x = torch.tensor(4.0 * rng.standard_normal((13, *shape)),
                     dtype=torch.float32).to(x_dtype)
    want = cnn_kernel.cnn_block1_plain(stage, x).numpy()
    offset = 4 if x_dtype == torch.float32 else 2
    got = _emulate(stage, x, x_offset=offset, grid=2, tensor=tensor)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_offset, grid, batch", [(0, 1, 1), (8, 3, 17),
                                                   (12, 5, 9), (4, 2, 19)])
def test_emulation_at_other_alignments_and_grids(x_offset, grid, batch):
    stage = _stage(29, 21, torch.float32, seed=4)
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (batch, 29, 21)), dtype=torch.float32)
    got = _emulate(stage, x, x_offset=x_offset, grid=grid)
    np.testing.assert_allclose(got, cnn_kernel.cnn_block1_plain(stage, x).numpy(),
                               rtol=1e-5, atol=1e-5)


class _WrongSlot(block1_plan.SimtMaps):
    def buffer_slot(self, item, g):  # groups 0 and 1 swapped in the buffer
        return np.asarray(item) * 4 + (g ^ 1)


class _WrongReadback(block1_plan.SimtMaps):
    def readback(self, i, lane):  # odd lanes store their even neighbour's
        return i * 32 + (np.asarray(lane) & ~1)


class _WrongTaps(block1_plan.TensorMaps):
    def taps(self, lane):  # taps 2t + 1 and 2t swapped
        t = super().taps(lane)
        return t[:, [1, 0, 2]]


@pytest.mark.parametrize("maps, tensor", [
    (_WrongSlot(), False), (_WrongReadback(), False), (_WrongTaps(), True),
    (dataclasses.replace(block1_plan.TENSOR_MAPS, partner=8), True),
])
def test_a_wrong_map_fails_the_emulation(maps, tensor):
    """One map moved: the emulation no longer equals the plain version, so
    the test above holds each map."""
    dtype = torch.bfloat16 if tensor else torch.float32
    stage = _stage(30, 20, dtype, seed=9)
    x = torch.tensor(4.0 * np.random.default_rng(6).standard_normal(
        (9, 30, 20)), dtype=torch.float32)
    want = cnn_kernel.cnn_block1_plain(stage, x).numpy()
    got = _emulate(stage, x, tensor=tensor, maps=maps)
    assert not np.allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=False)


def test_a_wrong_shift_fails_the_emulation(monkeypatch):
    """A stage read from its start, not from the tile's shift, reads the
    bytes before x (NaN) or the wrong elements."""
    stage = _stage(29, 21, torch.float32, seed=2)
    x = torch.tensor(np.random.default_rng(7).standard_normal((9, 29, 21)),
                     dtype=torch.float32)
    fill = block1_plan.stage_fill
    monkeypatch.setattr(block1_plan, "stage_fill",
                        lambda *a: fill(*a)[:1] + (0,) + fill(*a)[2:])
    got = _emulate(stage, x, x_offset=4)
    assert not np.allclose(got, cnn_kernel.cnn_block1_plain(stage, x).numpy(),
                           rtol=1e-5, atol=1e-5)


def test_ablation_switches_are_the_source_s():
    """Every -D switch of dev/block1_ablation.py names a macro the source
    defaults (`#ifndef`); only the cut is not held to the plain version."""
    from tpu_speech_commands_torch.dev import block1_ablation

    for name, spec in block1_ablation.VARIANTS.items():
        if spec is None:
            assert name == "simt"
            continue
        flags, held = spec
        for flag in flags:
            macro = re.fullmatch(r"-D(TSC_B1_\w+)=\d+", flag).group(1)
            assert f"#ifndef {macro}\n#define {macro} " in SRC, (name, macro)
        assert held == ("_CUT" not in " ".join(flags)), name
