"""The plan `csrc/cnn_classifier.cu`'s tiled implicit-GEMM classifier
(`tsc_cnn_classifier`) follows, as data: the tile of windows a block takes,
its shared-memory layout, the weight ring, the row order of each conv
stage's product and the work split over warps and threads.  The wrapper
hands these numbers to the kernel (`Plan.ints`), so the CUDA source and this
module describe one layout: change both together.

A block owns `tile` windows.  Their activations stay in shared memory, NHWC
in the compute type (bf16 in bf16 mode, f32 otherwise), in two buffers:

    A: the input (one channel), then stage 2's output, then stage 4's
    B: stage 1's output, then stage 3's, then the dense layer's (hidden)

each window `a_wpitch` / `b_wpitch` elements apart, each pixel `pitch(c)`
elements apart (c + 8 in bf16, c + 4 in f32: rows of a 16-byte multiple
that spread ldmatrix / float4 reads over the banks).  Before them sit a zero
row (`zero_elems` elements, read where a tap falls on the SAME padding) and
a ring of `ring` weight slots of `slot_bytes` each (6 in bf16, 3 in f32),
which take the shared memory the tile leaves.  A config whose one window
does not fit beside that ring takes unpadded pixels (pitch c) and a ring of
2 slots of a few K rows each instead, so that every input shape the SIMT
kernel's shared memory took still fits (`tests/test_torch_cnn_plan.py`).

Stage 1 (cin 1, K = 9) runs on the CUDA cores in both modes.  Stages 2-4
and the dense layer are products C[M, N] = A[M, K] W[K, N]:
- rows M = (window of the tile, output position, 2x2 quad), quad fastest,
  so a pooled position's four conv rows are adjacent (row (w P + p) Q + q,
  Q = 4 with a pool, 1 without); the VALID pool's dropped positions are no
  rows.  The dense layer's rows are the windows;
- columns N = cout;
- depth K = (tap, cin), tap-major: W is the lowered (3, 3, cin, cout) HWIO
  kernel, which is already, as memory, the K-major (9 cin, cout) matrix
  (cin is a multiple of 16, so no row needs padding); the kernel reads it
  in place.  The dense layer's K is the NHWC flatten, its (flat, hidden)
  kernel as is.
  A row of A is a pixel's channel run, so the im2col gather is only a
  per-row address; a tap outside the input reads the zero row.

W streams through the ring in K-chunks of `kc` rows (cp.async, ring - 1
slots in flight), read from L2 once a tile (once a round of the product
where its weights take more than one chunk).  The chunks of all four
products form one stream, so the next product's first chunks load while
this one computes.  bf16 mode: a warp takes a 16 x `unit` tile per round
(mma.sync m16n8k16, A by ldmatrix from the activation rows, B by
ldmatrix.trans from the slot); the pool is a max across the quad's lanes by
shuffle.  f32 mode: a thread takes `unit` rows x `cols` (8 or 4) columns per
round (a pooled position's 4 quads, so the pool is in registers; without a
pool 1, 2 or 4 rows, the fewest that take one round), neighbouring threads
neighbouring columns, so that row loads are broadcasts.

`emulate` runs the kernel's blocks on the CPU in torch: a flat shared
memory per block at the plan's offsets and pitches, the weight stream
through the ring's slots, each product's rounds of warp or thread tiles
with their taps read where the kernel reads them, and the bf16 roundings at
the same stores.  A wrong offset, pitch, chunk or round in the plan shows
there as a NaN or a wrong logit, where there is no card.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.cnn import relu6
from .cnn_lowering import Lowered, Stage

SMEM_OPTIN = 232448   # a block's opt-in shared memory on an H100
THREADS = 512
WARPS = THREADS // 32
# windows a block takes at most: in f32 the activations take twice the
# bytes, and 8 windows leave the weight ring room for whole stages
MAX_TILE = {torch.bfloat16: 16, torch.float32: 8}
# weight slots in flight: the bf16 products compute a slot in less time than
# an L2 read takes, so their ring is deeper
RING = {torch.bfloat16: 6, torch.float32: 3}
FALLBACK_RING = 2     # beside a window too large for RING
MMA_K = 16            # the depth of mma.m16n8k16
# K rows a chunk holds a multiple of: an mma's depth in bf16, a float4 of
# each row in f32
K_STEP = {torch.bfloat16: MMA_K, torch.float32: 4}
# the least bytes a weight slot takes in the padded layout: 144 rows of 32
# bf16 columns, 16 of 128 f32 columns
MIN_SLOT_BYTES = {torch.bfloat16: 11520, torch.float32: 8448}
F32_COLS = 8          # a thread's columns in f32 mode, or 4
WN_CHOICES = (64, 32, 16)   # a warp's tile width in bf16 mode
# Plan.ints: the header, then STAGE_INTS for each of the four products
HEADER = ("tile", "ring", "ring_off", "slot_bytes", "a_off", "b_off",
          "a_wpitch", "b_wpitch", "smem_bytes", "out_pitch1")
STAGE_INTS = ("in_pitch", "out_pitch", "k", "kc", "chunks", "rounds",
              "unit", "rows", "cols")


def elem_bytes(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def vec_elems(dtype) -> int:
    """Elements of a 16-byte copy: the padding of a slot's row."""
    return 16 // elem_bytes(dtype)


def pitch(c: int, dtype, padded: bool = True) -> int:
    """Elements from one pixel to the next in shared memory."""
    if c == 1:
        return 1
    if not padded:
        return c
    return c + (8 if dtype == torch.bfloat16 else 4)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class Product:
    """One product of the stream: conv stage 2, 3 or 4, or the dense layer."""

    name: str
    positions: int   # output positions a window (pooled, or the conv's own)
    quads: int       # conv rows an output position (4 with a pool, else 1)
    cin: int         # channels of an input row
    k: int           # the product's depth
    n: int           # columns
    in_pitch: int    # elements from one input pixel to the next
    out_pitch: int   # elements from one output pixel to the next
    kc: int          # K rows a chunk
    chunks: int
    rounds: int      # warp (bf16) or thread (f32) tiles each, in turn
    unit: int        # bf16: a warp's tile width; f32: a thread's rows
    cols: int        # f32: a thread's columns (bf16: 8, unused)

    @property
    def rows(self) -> int:
        """Rows of the product a window."""
        return self.positions * self.quads


@dataclasses.dataclass(frozen=True)
class Plan:
    dtype: torch.dtype
    tile: int
    ring: int            # weight slots
    zero_elems: int
    slot_bytes: int
    a_wpitch: int
    b_wpitch: int
    out_pitch1: int      # stage 1's output pixel pitch (its input's is 1)
    products: tuple[Product, ...]

    @property
    def elem(self) -> int:
        return elem_bytes(self.dtype)

    @property
    def ring_off(self) -> int:
        """The zero row sits at offset 0, the ring after it."""
        return _round_up(self.zero_elems * self.elem, 16)

    @property
    def a_off(self) -> int:
        return self.ring_off + self.ring * self.slot_bytes

    @property
    def b_off(self) -> int:
        return self.a_off + self.tile * self.a_wpitch * self.elem

    @property
    def smem_bytes(self) -> int:
        return self.b_off + self.tile * self.b_wpitch * self.elem

    def ints(self) -> list[int]:
        """What the kernel reads: HEADER, then STAGE_INTS a product."""
        out = [getattr(self, name) for name in HEADER]
        for prod in self.products:
            out += [getattr(prod, name) for name in STAGE_INTS]
        return out


def _kc(k: int, n: int, dtype, slot_bytes: int) -> int:
    row = (n + vec_elems(dtype)) * elem_bytes(dtype)
    step = K_STEP[dtype]
    kc = min(k, slot_bytes // row // step * step)
    if kc < step:
        raise ValueError(f"a weight row of {n} columns does not fit a slot "
                         f"of {slot_bytes} bytes {step} times")
    return kc


def _rounds(rows: int, n: int, dtype, quads: int) -> tuple[int, int, int]:
    """(rounds, unit, cols) for a product of `rows` x `n`."""
    if dtype == torch.bfloat16:
        mtiles = -(-rows // 16)
        wn = next(w for w in WN_CHOICES if n % w == 0)
        while wn > WN_CHOICES[-1] and mtiles * (n // wn) < WARPS:
            wn //= 2
        return -(-mtiles * (n // wn) // WARPS), wn, F32_COLS
    # rows: a pooled position's quads; without a pool the fewest that still
    # take one round (every chunk then loads once a tile).  Columns: 8, or 4
    # where 8 would leave half the threads or more idle
    for unit in ((4,) if quads == 4 else (1, 2, 4)):
        groups = -(-rows // unit)
        cols = F32_COLS if groups * (n // F32_COLS) > THREADS // 2 else 4
        rounds = -(-groups * (n // cols) // THREADS)
        if rounds == 1:
            break
    return rounds, unit, cols


def _layout(stages: list[Stage], hidden: int, dtype, padded: bool):
    """(products' shapes, a_wpitch, b_wpitch, out_pitch1) with pixels at
    `pitch(c, dtype, padded)`."""
    last = stages[3]
    products = []
    for i, st in enumerate(stages[1:], start=1):
        products.append(dict(
            name=f"stage{i + 1}", positions=st.h_out * st.w_out,
            quads=4 if st.pool else 1, cin=st.cin, k=9 * st.cin, n=st.cout,
            in_pitch=pitch(st.cin, dtype, padded),
            out_pitch=pitch(st.cout, dtype, padded)))
    products.append(dict(
        name="dense", positions=1, quads=1, cin=last.cout,
        k=last.h_out * last.w_out * last.cout, n=hidden,
        in_pitch=pitch(last.cout, dtype, padded), out_pitch=hidden))
    out_pitch1 = pitch(stages[0].cout, dtype, padded)
    a_wpitch = _round_up(max(
        stages[0].h_in * stages[0].w_in,
        products[0]["positions"] * products[0]["out_pitch"],
        products[2]["positions"] * products[2]["out_pitch"]), 8)
    b_wpitch = _round_up(max(
        stages[0].h_out * stages[0].w_out * out_pitch1,
        products[1]["positions"] * products[1]["out_pitch"], hidden), 8)
    return products, a_wpitch, b_wpitch, out_pitch1


def make_plan(stages: list[Stage], hidden: int, dtype,
              tile: int | None = None) -> Plan:
    """The plan for a lowered classifier's four stages and a dense layer of
    `hidden` units, in compute type `dtype`, for blocks of `tile` windows
    (default: the most that fit, at most MAX_TILE).  The weight slots take
    the shared memory the tile leaves: RING slots of at least MIN_SLOT_BYTES
    beside padded pixels where one window fits so, else 2 slots of at least
    K_STEP rows beside unpadded pixels.  ValueError where the kernel cannot
    take the config: a stage shape it does not handle, or one window that
    does not fit a block's shared memory even so; or a `tile` above the most
    that fit."""
    if dtype not in MIN_SLOT_BYTES:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    if len(stages) != 4 or stages[0].cin != 1:
        raise ValueError("the classifier kernel takes four stages, the first "
                         "with one input channel")
    if stages[0].cout % F32_COLS or not stages[0].pool or stages[0].stride != 1:
        raise ValueError("stage 1 needs stride 1, a pool and a multiple of 8 "
                         "channels")
    for st in stages[1:]:
        if st.cin % MMA_K or st.cout % MMA_K:
            raise ValueError(f"stages 2-4 need channels in multiples of "
                             f"{MMA_K}, got {st.cin} -> {st.cout}")
    if hidden % MMA_K:
        raise ValueError(f"the dense layer needs a multiple of {MMA_K} units")
    zero_elems = max(st.cin for st in stages[1:])
    elem = elem_bytes(dtype)
    free = SMEM_OPTIN - _round_up(zero_elems * elem, 16)
    widest = max([st.cout for st in stages[1:]] + [hidden])
    least_chunk = K_STEP[dtype] * (widest + vec_elems(dtype)) * elem
    for padded, ring, least_slot in ((True, RING[dtype], MIN_SLOT_BYTES[dtype]),
                                     (False, FALLBACK_RING, least_chunk)):
        products, a_wpitch, b_wpitch, out_pitch1 = _layout(stages, hidden,
                                                           dtype, padded)
        window = (a_wpitch + b_wpitch) * elem
        most = min(MAX_TILE[dtype], (free - ring * least_slot) // window)
        if most >= 1:
            break
    else:
        raise ValueError(
            f"the classifier kernel cannot take a {stages[0].h_in} x "
            f"{stages[0].w_in} input: one window's activations ({window} "
            f"bytes) and the weight ring exceed {SMEM_OPTIN} bytes of shared "
            "memory")
    tile = most if tile is None else tile
    if not 1 <= tile <= most:
        raise ValueError(f"a tile of {tile} windows: this config takes 1 to "
                         f"{most}")
    slot = (free - tile * window) // ring // 16 * 16
    done = []
    for prod in products:
        kc = _kc(prod["k"], prod["n"], dtype, slot)
        rounds, unit, cols = _rounds(tile * prod["positions"] * prod["quads"],
                                     prod["n"], dtype, prod["quads"])
        done.append(Product(**prod, kc=kc, chunks=-(-prod["k"] // kc),
                            rounds=rounds, unit=unit, cols=cols))
    return Plan(dtype, tile, ring, zero_elems, slot, a_wpitch, b_wpitch,
                out_pitch1, tuple(done))


# -- the CPU emulation -------------------------------------------------------
#
# Every offset below is in elements of the compute type from the start of a
# block's shared memory; the memory holds float32 values already rounded to
# the compute type where the kernel stores them.

def _store(v: torch.Tensor, dtype) -> torch.Tensor:
    """What a store into shared memory keeps: the compute type's value."""
    return v.to(dtype).to(torch.float32)


def conv_positions(prod: Product, m: torch.Tensor):
    """(window, output position, quad) of product rows `m` (any shape), in
    row_ref's order: window, output position, quad fastest."""
    win = m // prod.rows
    rr = m - win * prod.rows
    p, q = rr // prod.quads, rr % prod.quads
    return win, p, q


def tap_pixels(prod: Product, st: Stage | None, m: torch.Tensor) -> torch.Tensor:
    """(*m.shape, taps) input pixel of each tap of product rows `m` within
    their window (for the dense layer, the flatten's pixel), -1 where the
    tap falls on the SAME padding: what row_ref / tap_off compute."""
    win, p, q = conv_positions(prod, m)
    if st is None:  # the dense layer: tap t is pixel t
        taps = prod.k // prod.cin
        return torch.arange(taps).expand(*m.shape, taps)
    py, px = p // st.w_out, p % st.w_out
    cy = 2 * py + q // 2 if prod.quads == 4 else py
    cx = 2 * px + q % 2 if prod.quads == 4 else px
    (pad_h, _), (pad_w, _) = st.pads
    t = torch.arange(9)
    iy = (cy * st.stride - pad_h)[..., None] + t // 3
    ix = (cx * st.stride - pad_w)[..., None] + t % 3
    ok = (iy >= 0) & (iy < st.h_in) & (ix >= 0) & (ix < st.w_in)
    return torch.where(ok, iy * st.w_in + ix, -1)


class Ring:
    """The weight stream: every chunk of the four products in the kernel's
    order (a product of one chunk loads it once; one of more loads them all
    again each round), ring - 1 ahead of the step being read, into the slot
    the step before read (`issue_next` / `ring_step`)."""

    def __init__(self, plan: Plan, mats: list[torch.Tensor],
                 mem: torch.Tensor):
        self.plan, self.mats, self.mem = plan, mats, mem
        self.stream = [(i, c) for i, prod in enumerate(plan.products)
                       for _ in range(1 if prod.chunks == 1 else prod.rounds)
                       for c in range(prod.chunks)]
        self.slot_elems = plan.slot_bytes // plan.elem
        self.loaded = 0
        self.g = 0
        for slot in range(plan.ring - 1):
            self._issue(slot)

    def slot_base(self, slot: int) -> int:
        return self.plan.ring_off // self.plan.elem + slot * self.slot_elems

    def _issue(self, slot: int) -> None:
        if self.loaded < len(self.stream):
            i, c = self.stream[self.loaded]
            prod, w = self.plan.products[i], self.mats[i]
            k0 = c * prod.kc
            rows = min(prod.kc, prod.k - k0)
            pn = prod.n + vec_elems(self.plan.dtype)
            idx = (self.slot_base(slot) + torch.arange(rows)[:, None] * pn
                   + torch.arange(prod.n))
            self.mem[idx] = w[k0:k0 + rows]
        self.loaded += 1

    def step(self) -> int:
        """The next chunk's slot offset, after issuing the one ring - 1
        ahead."""
        ring = self.plan.ring
        self._issue((self.g + ring - 1) % ring)
        base = self.slot_base(self.g % ring)
        self.g += 1
        return base


def _epilogue(st: Stage, acc: torch.Tensor, cols: torch.Tensor,
              quads: int) -> torch.Tensor:
    """(items, rows, cols) conv sums -> the values stored: the inline relu
    before the pool, +bias and relu6 after it (the pool commutes with them),
    `quads` consecutive rows pooled into one."""
    bias = torch.tensor(st.bias)[cols][:, None]
    if st.inline_relu:
        pre = torch.tensor(st.pre_bias)[cols][:, None]
        mult = torch.tensor(st.mult)[cols][:, None]
        acc = relu6(torch.relu(acc + pre) * mult + bias)
    i, r, c = acc.shape
    acc = acc.view(i, r // quads, quads, c).amax(2)
    return acc if st.inline_relu else relu6(acc + bias)


def _product(plan: Plan, prod: Product, st: Stage | None, bias, ring: Ring,
             mem: torch.Tensor, in_off: int, in_wp: int, out_off: int,
             out_wp: int, nb: int) -> None:
    """One product over the block's nb windows, round by round as the
    kernel's warps (bf16) or threads (f32) take it."""
    bf16 = plan.dtype == torch.bfloat16
    m_valid = nb * prod.rows
    if bf16:
        ntiles = prod.n // prod.unit
        items = -(-m_valid // 16) * ntiles
        per_round, rm, cn = WARPS, 16, prod.unit
    else:
        cgs = prod.n // prod.cols
        items = -(-m_valid // prod.unit) * cgs
        per_round, rm, cn = THREADS, prod.unit, prod.cols
    pn = prod.n + vec_elems(plan.dtype)
    slot = ring.step() if prod.chunks == 1 else None
    for r in range(prod.rounds):
        item = r * per_round + torch.arange(per_round)
        item = item[item < items]
        if bf16:
            mt, nt = item // ntiles, item % ntiles
            m = mt[:, None] * 16 + torch.arange(16)
            cols = nt[:, None] * prod.unit + torch.arange(prod.unit)
        else:
            cg, rg = item % cgs, item // cgs
            m = rg[:, None] * rm + torch.arange(rm)
            groups = torch.arange(cn // 4)[:, None] * (prod.n // 2)
            cols = (groups + 4 * cg[:, None, None] + torch.arange(4)).flatten(1)
        ok = m < m_valid
        win = torch.where(ok, m // prod.rows, 0)
        pix = torch.where(ok[..., None], tap_pixels(prod, st, m), -1)
        acc = torch.zeros(len(item), rm, cn)
        for c in range(prod.chunks):
            if prod.chunks > 1:
                slot = ring.step()
            k = torch.arange(c * prod.kc, min((c + 1) * prod.kc, prod.k))
            tap, ci = k // prod.cin, k % prod.cin
            px = pix[..., tap]                       # (items, rm, kc)
            addr = torch.where(px >= 0, in_off + win[..., None] * in_wp
                               + px * prod.in_pitch + ci, ci)
            w = mem[slot + (k - c * prod.kc)[None, :, None] * pn
                    + cols[:, None, :]]              # (items, kc, cn)
            acc = acc + torch.bmm(mem[addr], w)
        if not len(item):
            continue
        if st is None:  # the dense layer
            v = relu6(acc + bias[cols][:, None])
        else:
            v = _epilogue(st, acc, cols, prod.quads)
        rows_out = m[:, ::prod.quads]                # each pooled group's first
        keep = rows_out < m_valid
        op = rows_out // prod.quads
        w_o, pos = op // prod.positions, op % prod.positions
        dst = out_off + (w_o * out_wp + pos * prod.out_pitch)[..., None] + \
            cols[:, None, :]
        mem[dst[keep]] = _store(v[keep], plan.dtype)


def _stage1(plan: Plan, st: Stage, w: torch.Tensor, mem: torch.Tensor,
            nb: int) -> None:
    """Stage 1 on the CUDA cores: each pooled position's 2 x 2 conv
    positions from its input patch, the epilogue, the pool, the store."""
    a_off, b_off = plan.a_off // plan.elem, plan.b_off // plan.elem
    positions = st.h_out * st.w_out
    win = torch.arange(nb)[:, None, None]
    p = torch.arange(positions)[None, :, None]
    q = torch.arange(4)[None, None, :]
    cy = 2 * (p // st.w_out) + q // 2
    cx = 2 * (p % st.w_out) + q % 2
    (pad_h, _), (pad_w, _) = st.pads
    acc = torch.zeros(nb, positions, 4, st.cout)
    for tap in range(9):
        iy, ix = cy - pad_h + tap // 3, cx - pad_w + tap % 3
        ok = (iy >= 0) & (iy < st.h_in) & (ix >= 0) & (ix < st.w_in)
        addr = a_off + win * plan.a_wpitch + iy * st.w_in + ix
        v = torch.where(ok, mem[torch.where(ok, addr, 0)], 0.0)
        acc = acc + v[..., None] * w[tap]
    bias = torch.tensor(st.bias)
    if st.inline_relu:
        acc = relu6(torch.relu(acc + torch.tensor(st.pre_bias))
                    * torch.tensor(st.mult) + bias)
    else:
        acc = relu6(acc + bias)
    out = acc.amax(2)                                # (nb, positions, cout)
    dst = b_off + (win[..., 0] * plan.b_wpitch + p[..., 0] * plan.out_pitch1
                   )[..., None] + torch.arange(st.cout)
    mem[dst] = _store(out, plan.dtype)


def emulate(lowered: Lowered, plan: Plan, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function on the CPU, block by block: (B, H, W) features
    -> (B, classes) float32 logits.  Each block of `plan.tile` windows (the
    last one ragged) gets a flat shared memory of `plan.smem_bytes`, NaN
    wherever nothing was stored, with the zero row, the ring, A and B at the
    plan's offsets and pitches; the weights stream through the ring's slots
    chunk by chunk; each product runs its rounds of warp (bf16) or thread
    (f32) tiles, reads its taps and weights where the kernel reads them and
    stores its epilogue's output, rounded to the compute type."""
    dt = plan.dtype
    elem = plan.elem

    def mat(a) -> torch.Tensor:
        return _store(torch.tensor(a).reshape(-1, a.shape[-1]), dt)

    stages = lowered.stages
    mats = [mat(st.kernel) for st in stages[1:]] + [mat(lowered.dense_w)]
    w1 = mat(stages[0].kernel)
    dense_bias = torch.tensor(lowered.dense_b)
    head_w, head_b = mat(lowered.head_w), torch.tensor(lowered.head_b)
    a_off, b_off = plan.a_off // elem, plan.b_off // elem
    n_in = stages[0].h_in * stages[0].w_in
    logits = []
    for b0 in range(0, x.shape[0], plan.tile):
        xb = x[b0:b0 + plan.tile].reshape(-1, n_in).to(torch.float32)
        nb = xb.shape[0]
        mem = torch.full((plan.smem_bytes // elem,), float("nan"))
        ring = Ring(plan, mats, mem)
        mem[:plan.ring_off // elem] = 0.0            # the zero row
        idx = a_off + torch.arange(nb)[:, None] * plan.a_wpitch + \
            torch.arange(n_in)
        mem[idx] = _store(xb, dt)
        _stage1(plan, stages[0], w1, mem, nb)
        for i, prod in enumerate(plan.products):
            from_b = i % 2 == 0      # stage 2 B -> A, 3 A -> B, 4 B -> A, dense A -> B
            src, dst = (b_off, a_off) if from_b else (a_off, b_off)
            src_wp, dst_wp = ((plan.b_wpitch, plan.a_wpitch) if from_b
                              else (plan.a_wpitch, plan.b_wpitch))
            st = stages[i + 1] if i < 3 else None
            _product(plan, prod, st, dense_bias, ring, mem, src, src_wp,
                     dst, dst_wp, nb)
        hidden = plan.products[-1].n
        hv = mem[b_off + torch.arange(nb)[:, None] * plan.b_wpitch
                 + torch.arange(hidden)]
        logits.append(hv @ head_w + head_b)
    return torch.cat(logits)
