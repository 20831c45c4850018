"""The plan of `csrc/cnn_block1.cu`, the CNN block-1 kernel: its constants,
tile, shared memory and route, and a CPU emulation of its index maps.

The kernel's constants (warps, chunk, the ring's depth, the tile's windows
and stage budget, the launch bounds' blocks an SM, the store mode) and its
`smem_bytes` have their twins here; `tests/test_torch_block1_plan.py` reads
them out of the source.  The emulation (`emulate`) follows one launch's
data the way the kernel moves it, each step by the map the kernel applies:
- `tile_windows`, `block_tiles`: the persistent grid's tiles, block b
  taking windows [b B / grid, (b + 1) B / grid) in tiles of up to
  `tile_windows` windows;
- `stage_fill`: a tile's bytes as they lie in x (f32 or bf16) in a ring
  stage, its 16-byte-aligned interior by the bulk copy and the elements
  before and after it by plain loads, the rest of the stage untouched (NaN
  in the emulation);
- `warp_chunks`: which consumer warp takes which chunk of CHUNK items
  (ITEMS a lane), warp w the block's chunks w, w + 8, ... over all its
  tiles;
- `item_coords`: a lane's item -> (window, oy, ox) by `fast_div`, a
  multiplication by a host-made reciprocal;
- `patch`: the 4 x 4 input patch, SAME padding by predicates on the outer
  rows and columns;
- `group`, `buffer_slot`, `readback`: the channel group a lane computes at
  each step (rotated by lane), where it lands in the warp's 2 KB buffer and
  which float4 each lane stores from there;
- the tensor-core path (bf16, `TENSOR_MAPS`): the lane's A columns (taps),
  its rows (quads of 4 pooled positions), the B fragments, the pool's
  shuffle partner and the channels a lane stores, on the mma.m16n8k16
  fragment layout of `gru_plan` (A_ROW / A_COL, B_ROW / B_COL, C_ROW /
  C_COL).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gru_plan import A_COL, A_ROW, B_COL, B_ROW, C_COL, C_ROW

COUT = 16
TAPS = 9
CONSUMER_WARPS = 8   # the consumer warps a block; one producer warp beside
ITEMS = 2            # items (pooled positions) a lane takes at once
CHUNK = 32 * ITEMS   # items a warp takes at once
CHUNK_BYTES = CHUNK * COUT * 4
STAGES = 3           # the input ring's depth
MAX_TILE = 8         # windows a tile at most
STAGE_BUDGET = MAX_TILE * 2560  # bytes of windows a stage aims at
BLOCKS_PER_SM = 2    # the launch bounds' minimum
STORE = 2            # 0 scalar, 1 vector, 2 through the warp's buffer, 3 bulk
MMA = 0              # bf16 on the tensor cores
SLACK = 32           # a stage's bytes beyond its windows'
WEIGHT_BYTES = (TAPS + 1) * COUT * 4
BARRIER_OFF = WEIGHT_BYTES
SMEM_LIMIT = 232448  # a block's opt-in shared memory on an H100


def _align(v: int, m: int) -> int:
    return -(-v // m) * m


def ring_off(stages: int = STAGES) -> int:
    return _align(BARRIER_OFF + 16 * stages, 128)


def stage_bytes(tile: int, window_bytes: int) -> int:
    """stage_bytes() of the source: a tile's windows to 16 bytes, and slack
    for the shift of an unaligned tile."""
    return _align(tile * window_bytes, 16) + SLACK


def smem_bytes(tile: int, window_bytes: int, stages: int = STAGES,
               store: int = STORE) -> int:
    """smem_bytes() of the source: weights and bias, the barriers, the ring,
    then the warps' output buffers (two each for bulk stores)."""
    buffers = 2 if store == 3 else 1
    return (ring_off(stages) + stages * stage_bytes(tile, window_bytes)
            + (CONSUMER_WARPS * buffers * CHUNK_BYTES if store >= 2 else 0))


def tile_windows(window_bytes: int, max_tile: int = MAX_TILE,
                 budget: int = STAGE_BUDGET) -> int:
    """tile_windows() of the source: as many windows as the stage's budget
    holds, at least one, at most `max_tile`."""
    return min(max_tile, max(1, budget // window_bytes))


def kernel_for(h: int, w: int, elem_bytes: int) -> str:
    """The block-1 kernel a config gets, before any launch: "cnn_block1"
    (this plan's kernel) where its ring fits a block's shared memory, else
    "cnn_block1_simt" (`tsc_cnn_block1_simt`, which takes one window up to
    the opt-in limit; 200 x 200 f32 or bf16 features take it)."""
    window_bytes = h * w * elem_bytes
    fits = smem_bytes(tile_windows(window_bytes), window_bytes) <= SMEM_LIMIT
    return "cnn_block1" if fits else "cnn_block1_simt"


def block_tiles(block: int, grid: int, batch: int,
                tile: int) -> list[tuple[int, int]]:
    """(first window, windows) of each tile block `block` of a persistent
    grid of `grid` (at most `batch`) blocks walks: its windows
    [block_end(b - 1), block_end(b)), the batch split as evenly as whole
    windows allow."""
    def block_end(b):
        return (b + 1) * batch // grid

    w0, w1 = block_end(block - 1), block_end(block)
    return [(fw, min(tile, w1 - fw)) for fw in range(w0, w1, tile)]


def div_magic(d: int) -> int:
    """ceil(2^32 / d), the source's div_magic."""
    return -(-(1 << 32) // d)


def fast_div(n, magic: int):
    """(n * magic) >> 32: floor(n / d) for n * d < 2^32."""
    return (np.asarray(n, np.uint64) * np.uint64(magic)) >> np.uint64(32)


def item_coords(item, n_pos: int, wp: int):
    """Items -> (window, oy, ox) as the kernel maps them."""
    item = np.asarray(item, np.int64)
    win = fast_div(item, div_magic(n_pos)).astype(np.int64)
    pos = item - win * n_pos
    oy = fast_div(pos, div_magic(wp)).astype(np.int64)
    return win, oy, pos - oy * wp


def warp_chunks(chunks_per_tile: list[int], warps: int = CONSUMER_WARPS):
    """[(warp, tile index k, chunk c)] for a block whose tiles hold these
    chunks: warp w takes the block's chunks w, w + warps, ... over all its
    tiles in order (the consumer loop's walk)."""
    out = []
    for w in range(warps):
        k, c = 0, w
        while k < len(chunks_per_tile):
            if c >= chunks_per_tile[k]:
                c -= chunks_per_tile[k]
                k += 1
                continue
            out.append((w, k, c))
            c += warps
    return out


def stage_fill(x_bytes: np.ndarray, x_addr: int, tile: int, fw: int, nb: int,
               window_bytes: int, elem: int):
    """One ring stage as the producer fills it for the tile of nb windows
    from window fw (x's bytes at address x_addr): (stage bytes with NaN
    where nothing was copied, the shift from the stage's start to the
    tile's first byte, the bulk copy's byte count)."""
    begin = x_addr + fw * window_bytes
    end = begin + nb * window_bytes
    base, a0, a1 = begin & ~15, (begin + 15) & ~15, end & ~15
    stage = np.full(stage_bytes(tile, window_bytes), 0xFF, np.uint8)

    def copy(lo, hi):
        assert (hi - lo) % elem == 0 and lo % elem == 0
        stage[lo - base:hi - base] = x_bytes[lo - x_addr:hi - x_addr]

    bulk = 0
    if a1 <= a0:
        copy(begin, end)
    else:
        copy(begin, a0)
        copy(a1, end)
        assert a0 % 16 == 0 and (a0 - base) % 16 == 0 and (a1 - a0) % 16 == 0
        copy(a0, a1)  # the bulk copy: 16-byte aligned at both ends
        bulk = a1 - a0
    return stage, begin - base, bulk


def _rnd(v, bf16: bool):
    if not bf16:
        return np.asarray(v, np.float32)
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16).float().numpy()


def _elements(stage: np.ndarray, shift: int, bf16_in: bool) -> np.ndarray:
    """The stage's bytes from `shift` on as f32 values (bf16 widened)."""
    raw = stage[shift:].copy()
    if bf16_in:
        raw = raw[:len(raw) // 2 * 2].view(np.uint16).astype(np.uint32) << 16
        return raw.view(np.float32)
    return raw[:len(raw) // 4 * 4].view(np.float32)


def patch(vals: np.ndarray, win, oy, ox, h: int, w: int) -> np.ndarray:
    """(lanes, 4, 4) patches: input rows 2 oy - 1 .. 2 oy + 2, columns
    2 ox - 1 .. 2 ox + 2 of each lane's window; only the outer rows and
    columns are tested against the padding."""
    row_ok = np.stack([oy > 0, np.ones_like(oy, bool), np.ones_like(oy, bool),
                       2 * oy + 2 < h], 1)
    col_ok = np.stack([ox > 0, np.ones_like(ox, bool), np.ones_like(ox, bool),
                       2 * ox + 2 < w], 1)
    origin = win * h * w + (2 * oy - 1) * w + 2 * ox - 1
    out = np.zeros((len(win), 4, 4), np.float32)
    for r in range(4):
        for c in range(4):
            ok = row_ok[:, r] & col_ok[:, c]
            out[ok, r, c] = vals[origin[ok] + r * w + c]
    return out


class SimtMaps:
    """The CUDA-core chunk's maps."""

    def group(self, kk: int, lane):
        """The channel group a lane computes at step kk (rotated by lane,
        so that a phase of 8 lanes stores into 8 distinct bank quads)."""
        return (kk + (np.asarray(lane) >> 1)) & 3

    def item(self, it: int, lane):
        """A lane's it-th item of the chunk."""
        return 32 * it + np.asarray(lane)

    def buffer_slot(self, item, g):
        """The float4 of the warp's buffer that (item, group) fills."""
        return np.asarray(item) * 4 + g

    def readback(self, i: int, lane):
        """The float4 of the buffer (and of the chunk's output) a lane
        stores at step i: 512 contiguous bytes a warp."""
        return i * 32 + np.asarray(lane)


@dataclasses.dataclass(frozen=True)
class TensorMaps:
    """The tensor-core chunk's maps (bf16): tiles of 16 rows, 4 pooled
    positions each."""

    partner: int = 4  # the pool's shuffle: the lane holding the other qx

    def rows(self, lane):
        """Lane (g, t) holds rows g and g + 8: quads (qy 0, 1) at qx = g & 1
        of the tile's pooled position g >> 1."""
        g = np.asarray(lane) >> 2
        return g >> 1, g & 1

    def taps(self, lane):
        """(lanes, 3) taps of a lane's A columns 2t, 2t + 1 and 2t + 8 (a
        tap only at t = 0, tap 8); -1: a zero column."""
        t = np.asarray(lane) & 3
        return np.stack([2 * t, 2 * t + 1, np.where(t == 0, 8, -1)], 1)

    def channels(self, lane):
        """The first of the two channels a lane stores: n-tile g & 1's
        columns 2t, 2t + 1."""
        lane = np.asarray(lane)
        return 8 * ((lane >> 2) & 1) + 2 * (lane & 3)


SIMT_MAPS = SimtMaps()
TENSOR_MAPS = TensorMaps()


def _chunk_simt(vals, item0, n_items, geo, wv, bias, maps, out_chunk):
    h, w, n_pos, wp = geo
    lanes = np.arange(32)
    buf = np.full((CHUNK * 4, 4), np.nan, np.float32)
    for it in range(ITEMS):
        local = maps.item(it, lanes)
        item = np.minimum(item0 + local, n_items - 1)
        win, oy, ox = item_coords(item, n_pos, wp)
        v = patch(vals, win, oy, ox, h, w)
        for kk in range(4):
            g = maps.group(kk, lanes)
            acc = np.zeros((32, 4, 4), np.float32)  # (lane, quad, channel)
            for tap in range(TAPS):
                dy, dx = divmod(tap, 3)
                w4 = wv[tap][4 * g[:, None] + np.arange(4)]  # (lane, 4)
                for q in range(4):
                    xv = v[:, (q >> 1) + dy, (q & 1) + dx]
                    acc[:, q] = np.float32(acc[:, q] + xv[:, None] * w4)
            m = acc.max(axis=1)
            r = np.clip(m + bias[4 * g[:, None] + np.arange(4)], 0.0, 6.0)
            buf[maps.buffer_slot(local, g)] = r
    n_valid = min(CHUNK, n_items - item0)
    for i in range(4 * ITEMS):
        f = maps.readback(i, lanes)
        keep = f < 4 * n_valid
        out_chunk[f[keep]] = buf[f[keep]]


def _chunk_tensor(vals, item0, n_items, geo, wv, bias, maps, out_chunk):
    """8 tiles of 4 pooled positions; A, B and C through the fragment maps
    (A_ROW / A_COL ...), the product in f32 on the bf16 values."""
    h, w, n_pos, wp = geo
    lanes = np.arange(32)
    pp, qx = maps.rows(lanes)
    taps = maps.taps(lanes)
    ch = maps.channels(lanes)
    # B (16 x 16): K = taps (9 .. 15 zero), N = channels
    b_full = np.zeros((16, COUT), np.float32)
    b_full[:TAPS] = wv
    for j in range(CHUNK // 4):
        slot = item0 + 4 * j + pp
        item = np.minimum(slot, n_items - 1)
        win, oy, ox = item_coords(item, n_pos, wp)
        p = patch(vals, win, oy, ox, h, w)  # (lane, 4, 4)
        # the lane's A values x[qy][i]: rows g (qy 0) and g + 8 (qy 1)
        a_tile = np.zeros((16, 16), np.float32)
        a_vals = np.zeros((32, 2, 3), np.float32)
        for i in range(3):
            tap = taps[:, i]
            dy, dx = np.where(tap >= 0, tap // 3, 0), np.where(tap >= 0, tap % 3, 0)
            for qy in range(2):
                a_vals[:, qy, i] = np.where(tap >= 0,
                                            p[lanes, qy + dy, qx + dx], 0.0)
        # register element e of a lane: (qy, column) -> A[A_ROW, A_COL]
        for e in range(8):
            qy = (e >> 1) & 1
            col = A_COL[:, e]
            i = np.where(col < 8, col & 1, 2 + (col & 1))  # 2t + 9 -> zero
            val = np.where(i < 3, a_vals[lanes, qy, np.minimum(i, 2)], 0.0)
            a_tile[A_ROW[:, e], col] = _rnd(val, True)
        d = np.zeros((2, 16, 8), np.float32)
        for n in range(2):
            b = np.zeros((16, 8), np.float32)
            for e in range(4):
                b[B_ROW[:, e], B_COL[:, e]] = b_full[B_ROW[:, e], 8 * n + B_COL[:, e]]
            d[n] = a_tile @ b
        # C fragments, the pool over rows g, g + 8, then the partner's qx
        c = np.stack([d[n][C_ROW, C_COL] for n in range(2)], 1)  # (lane, n, 4)
        pooled = np.maximum(c[:, :, 0:2], c[:, :, 2:4])  # (lane, n, 2)
        pooled = np.maximum(pooled, pooled[lanes ^ maps.partner])
        odd = ((lanes >> 2) & 1).astype(bool)
        r = np.where(odd[:, None], pooled[:, 1], pooled[:, 0])
        r = np.clip(r + bias[ch[:, None] + np.arange(2)], 0.0, 6.0)
        keep = slot < n_items
        for k in range(2):
            out_chunk[(slot[keep] - item0) * COUT + ch[keep] + k] = r[keep, k]


def emulate(x: np.ndarray, kernel: np.ndarray, bias: np.ndarray, bf16: bool,
            *, bf16_in: bool = False, x_offset: int = 0, grid: int = 3,
            tensor: bool = False, maps=None) -> np.ndarray:
    """Run the kernel's maps on the CPU.  x (B, H, W) float32 values (held
    as bf16 when bf16_in, which must then be bf16 values); kernel (3, 3, 1,
    16) and bias (16,) of the lowered block 1 (the kernel's bf16 values in
    bf16 mode); x placed `x_offset` bytes past a 16-byte boundary (a
    multiple of the element size); a persistent grid of at most `grid`
    blocks, one a window at most; `tensor` the bf16 tensor-core path.  Returns (B, H//2, W//2, 16)
    float32, NaN where nothing was written."""
    if tensor and not bf16:
        raise ValueError("the tensor-core path is bf16 mode's")
    maps = maps or (TENSOR_MAPS if tensor else SIMT_MAPS)
    batch, h, w = x.shape
    hp, wp = h // 2, w // 2
    n_pos = hp * wp
    elem = 2 if bf16_in else 4
    xf = np.ascontiguousarray(x, np.float32)
    x_bytes = ((xf.view(np.uint32) >> 16).astype(np.uint16) if bf16_in
               else xf).view(np.uint8).reshape(-1)
    x_addr = 4096 + x_offset
    window_bytes = h * w * elem
    tile = tile_windows(window_bytes)
    grid = min(grid, batch)
    wv = _rnd(np.asarray(kernel, np.float32).reshape(TAPS, COUT), bf16)
    bias = np.asarray(bias, np.float32)
    geo = (h, w, n_pos, wp)
    out = np.full(batch * n_pos * COUT, np.nan, np.float32)
    written = np.zeros(batch * n_pos, np.int64)
    run = _chunk_tensor if tensor else _chunk_simt
    for block in range(grid):
        mine = block_tiles(block, grid, batch, tile)
        stages = {}
        for k, (fw, nb) in enumerate(mine):  # the producer's walk
            stages[k] = stage_fill(x_bytes, x_addr, tile, fw, nb, window_bytes,
                                   elem)
        items = [nb * n_pos for _, nb in mine]
        chunks = [-(-n // CHUNK) for n in items]
        for _, k, c in warp_chunks(chunks):
            stage, shift, _ = stages[k]
            vals = _rnd(_elements(stage, shift, bf16_in), bf16)
            first = mine[k][0] * n_pos
            item0 = c * CHUNK
            n_valid = min(CHUNK, items[k] - item0)
            chunk_out = np.full(CHUNK * COUT, np.nan, np.float32)
            run(vals, item0, items[k], geo, wv, bias, maps,
                chunk_out.reshape(-1, 4) if not tensor else chunk_out)
            lo = (first + item0) * COUT
            out[lo:lo + n_valid * COUT] = chunk_out[:n_valid * COUT]
            written[first + item0:first + item0 + n_valid] += 1
    if (written > 1).any():
        raise AssertionError("an item was written twice")
    return out.reshape(batch, hp, wp, COUT)
