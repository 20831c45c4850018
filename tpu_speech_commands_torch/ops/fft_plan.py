"""The plans the register-resident real-input FFTs follow, built in float64
numpy: `csrc/mfcc_frontend.cu`'s register body (`fft_plan`, n_fft a power
of two), route ct's mixed-radix kernel `csrc/mixed_fft_frontend.cu`
(`mixed_plan`, `MIXED_PLANS`) and its wide kernel above n_fft 4096, a frame
over two or four warps (`csrc/wide_fft_frontend_*.cu`, `wide_plan`,
`WIDE_PLANS`): the passes, their index maps and twiddle tables, the
untangle twiddles, the shared-memory layout, and the packed filterbank's
work split over the lanes.

The kernels mirror these; tests/test_torch_fft_plan.py,
tests/test_torch_mixed_fft.py and tests/test_torch_wide_fft.py run a numpy
emulation of the same passes on the same tables (`emulate_rfft`) against
np.fft.rfft and the plain frontends.  The mixed-radix plans keep the layout below with other radices
and lane counts.  For n_fft a power of two in [FFT_MIN, FFT_MAX]:

- a real frame x of n_fft samples is the complex sequence z[n] = x[2n] + i
  x[2n + 1] of N = n_fft / 2 points;
- Z = DFT_N(z) runs as Stockham passes of radix 16, 16, then N / 256 (two
  passes, 16 and N / 16, where N <= 256).  A frame is held by `lanes` lanes
  of one warp, `values` points a lane, in registers.  Pass p with stride Ns
  (the product of the radices before it) and radix R: butterfly j in [0, N /
  R) reads z[j + r N / R], r < R; its inputs r >= 1 are multiplied by
  W_{Ns R}^{r (j mod Ns)}; a DFT-R in registers; output s goes to (j - c) R
  + c + s Ns, c = j mod Ns.  Lane l owns butterflies l + lanes b, b <
  ceil(values / R) (a wide plan's last one only where it is < N / R: its
  power-of-two radices need not divide V).  Pass 0
  reads the audio itself; every later pass reads what the one before wrote;
- X[k] = E + W_{2N}^k O and X[N - k] = conj(E - W_{2N}^k O), E = (Z[k] +
  conj Z[N - k]) / 2, O = -i (Z[k] - conj Z[N - k]) / 2: one lane takes the
  pair (k, N - k), k = l + lanes i < N / 2, and lane 0 also bin N / 2.

A pass's writes land in a per-frame buffer of N float2: swizzled (`swizzle`:
slot i ^ ((i >> 4) & 15) in units of float2) before a pass, so that the
strided writes of a Stockham pass and the next pass's reads are both free of
bank conflicts; in natural order (linear) after the last pass, so that the
untangle's reads of Z[k] and of Z[N - k] in reverse are too.  Frames that
share a half-warp (lanes < 16) sit `lanes` float2 apart in bank terms.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

FFT_MIN, FFT_MAX = 128, 4096
RADIX = 16
WARPS = 8  # a block: 8 warps, one window
# a wide plan's block (a frame of 64 or 128 lanes): at most 4 warps, 128
# threads, the launch bounds' block (register_fft.cuh's kWideThreads)
WIDE_WARPS = 4
# an H100 SM: 228 KB of shared memory, of which a block may opt in to 227
# KB and the CUDA runtime reserves 1 KB a block; 64 warps
SMEM_OPTIN = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
MAX_WARPS_PER_SM = 64


def takes_register_fft(n_fft: int) -> bool:
    """Whether the register-resident design takes n_fft; every other power
    of two goes to the kernel's radix-2 body."""
    return FFT_MIN <= n_fft <= FFT_MAX and not n_fft & (n_fft - 1)


@dataclasses.dataclass(frozen=True)
class FftPlan:
    n_fft: int
    n: int                # complex points, n_fft / 2
    lanes: int            # lanes a frame
    values: int           # complex values a lane
    radices: tuple        # a pass's radix
    strides: tuple        # a pass's Ns, the product of the radices before it
    pass_offsets: tuple   # a pass's first row in `twiddle` (-1: no twiddles)
    untangle_offset: int  # the untangle's first row in `twiddle`
    pitch: int            # float2 from one frame's buffer to the next
    min_blocks: int       # the kernel's __launch_bounds__ blocks an SM
    warps: int            # a block's, before fft_layout halves them to fit
    twiddle: np.ndarray   # (n_tw, 2) float64 cos, sin rows

    @property
    def frames_per_warp(self) -> int:
        return max(1, 32 // self.lanes)

    @property
    def warps_per_frame(self) -> int:
        return max(1, self.lanes // 32)

    @property
    def staged(self) -> bool:
        """Whether the block stages the twiddles and the packed weights in
        shared memory; a frame over several warps reads them through the
        read-only cache (a block holds too few frames to repay staging)."""
        return self.lanes <= 32

    @property
    def max_warps(self) -> int:
        """The launch bounds' warps a block."""
        return WARPS if self.staged else WIDE_WARPS

    @property
    def lane_slots(self) -> int:
        """The complex values a lane holds in registers: the most of any
        pass, ceil(values / R) butterflies of R."""
        return max(-(-self.values // r) * r for r in self.radices)


@functools.lru_cache()
def fft_plan(n_fft: int) -> FftPlan:
    """The pass structure and twiddle tables for n_fft (`takes_register_fft`).
    `twiddle` holds, for each pass p > 0, (R - 1) x Ns rows W_{Ns R}^{r c}
    (row (r - 1) Ns + c, c < Ns), then N / 2 + 1 rows W_{2N}^k."""
    if not takes_register_fft(n_fft):
        raise ValueError(f"the register FFT takes n_fft a power of two in "
                         f"[{FFT_MIN}, {FFT_MAX}], got {n_fft}")
    n = n_fft // 2
    values = max(RADIX, n // 32)
    radices, rest = [], n
    while rest > 1:
        radices.append(min(RADIX, rest))
        rest //= radices[-1]
    return build_plan(n_fft, values, tuple(radices),
                      {16: 4, 32: 2}.get(values, 1), WARPS)


def build_plan(n_fft: int, values: int, radices: tuple, min_blocks: int,
               warps: int) -> FftPlan:
    """The plan of n_fft / 2 complex points, `values` a lane, in Stockham
    passes of `radices` (in order), with its float64-built twiddle rows."""
    n = n_fft // 2
    strides = tuple(int(np.prod(radices[:p])) for p in range(len(radices)))
    rows, offsets = [], []
    for radix, ns in zip(radices, strides):
        if ns == 1:
            offsets.append(-1)
            continue
        offsets.append(sum(len(r) for r in rows))
        r = np.arange(1, radix, dtype=np.float64)[:, None]
        c = np.arange(ns, dtype=np.float64)[None, :]
        rows.append((-2.0 * np.pi * r * c / (ns * radix)).ravel())
    untangle = sum(len(r) for r in rows)
    rows.append(-np.pi * np.arange(n // 2 + 1, dtype=np.float64) / n)
    ang = np.concatenate(rows)
    lanes = n // values
    return FftPlan(
        n_fft=n_fft, n=n, lanes=lanes, values=values, radices=tuple(radices),
        strides=strides, pass_offsets=tuple(offsets), untangle_offset=untangle,
        pitch=n + (lanes if lanes < 16 else 0), min_blocks=min_blocks,
        warps=warps, twiddle=np.stack([np.cos(ang), np.sin(ang)], axis=-1))


# The mixed-radix plans of csrc/mixed_fft_frontend.cu (its TSC_MIXED_PLANS
# table): n_fft -> (values a lane, the passes' radices, the launch bounds'
# blocks an SM, warps a block).  n_fft = 256 m, m in 3 .. 15 not a power of
# two: the CT-eligible sizes (n_fft = 128 n2, n2 even) up to FFT_MAX that
# are not powers of two.  V is the largest 2^k q <= 64 (q the odd part of
# m), so that a lane holds whole butterflies of every pass and L = N / V <=
# 32 lanes hold a frame; the power-of-two part runs in as few passes as
# radices dividing V allow, in the order with the fewest shared-memory
# wavefronts (tests/test_torch_mixed_fft.py counts them), then one pass for
# each odd prime factor of m.  The bounds and the block are the fastest of
# 1 or 2 blocks x 2, 4 or 8 warps on an H100 (dev/mixed_ablation.py
# --sweep, PERF.md): 2 blocks (128 registers; 1280, 1536 and 2304 spill
# 32-76 bytes) where the frame slots leave room for 3 or more blocks of 4
# warps, else 1.  A config
# whose block does not fit SMEM_OPTIN takes fewer warps (fft_layout).
MIXED_PLANS = {
    768: (48, (16, 8, 3), 2, 4),
    1280: (40, (8, 2, 8, 5), 2, 8),
    1536: (48, (16, 16, 3), 2, 4),
    1792: (56, (8, 2, 8, 7), 1, 2),
    2304: (36, (2, 4, 4, 4, 3, 3), 2, 4),
    2560: (40, (4, 8, 8, 5), 2, 4),
    2816: (44, (2, 4, 4, 4, 11), 1, 2),
    3072: (48, (4, 16, 8, 3), 1, 4),
    3328: (52, (2, 4, 4, 4, 13), 1, 4),
    3584: (56, (4, 8, 8, 7), 1, 4),
    3840: (60, (2, 4, 4, 4, 3, 5), 1, 4),
}


def takes_mixed_fft(n_fft: int) -> bool:
    """Whether the mixed-radix register FFT has a plan for n_fft."""
    return n_fft in MIXED_PLANS


@functools.lru_cache()
def mixed_plan(n_fft: int) -> FftPlan:
    """The mixed-radix plan for n_fft (`MIXED_PLANS`), with the register
    body's frame-slot pad below 16 lanes."""
    if not takes_mixed_fft(n_fft):
        raise ValueError(f"the mixed-radix register FFT takes n_fft in "
                         f"{sorted(MIXED_PLANS)}, got {n_fft}")
    return build_plan(n_fft, *MIXED_PLANS[n_fft])


# The wide plans of csrc/wide_fft_frontend_*.cu (their TSC_WIDE_PLANS
# tables): n_fft -> (values a lane, the passes' radices, the launch bounds'
# blocks an SM, warps a block).  n_fft = 256 m, m in 17 .. 62 but 32: the
# sizes above FFT_MAX that the JAX package's CT kernel takes (n_fft = 128
# n2, n2 even) and that are not powers of two, up to the longest window a
# 1 s buffer holds.  `wide_rule` gives every entry: V is the largest 2^k q
# <= 64 (q the odd part of m), so L = N / V is 64 lanes (m < 32) or 128
# (m > 32), two or four warps a frame; the power-of-two part of N runs in
# the fewest passes of radices up to 16, their exponents as even as they
# split, the larger first (a radix that does not divide V leaves a lane's
# last butterfly to some lanes only); then one pass for each odd prime
# factor of m, the smallest first.  A block is 4 warps (two frames of 64
# lanes, or one of 128), 128 threads.  The launch bounds' blocks an SM are
# the fastest of 2, 3 and 4 (255, 168 and 128 registers a thread) on an
# H100 where it beats 3 by more than 1% (dev/wide_ablation.py over every
# plan, PERF.md): 4 for most plans up to 10752 whose spills at 128
# registers are small, 2 for the primes 59 and 61 (15104, 15616), whose
# odd DFT spills 1 KB at 168.
WIDE_PLANS = {
    4352: (34, (16, 8, 17), 4, 4),
    4608: (36, (16, 16, 3, 3), 3, 4),
    4864: (38, (16, 8, 19), 4, 4),
    5120: (40, (8, 8, 8, 5), 4, 4),
    5376: (42, (16, 8, 3, 7), 4, 4),
    5632: (44, (16, 16, 11), 4, 4),
    5888: (46, (16, 8, 23), 4, 4),
    6144: (48, (16, 8, 8, 3), 3, 4),
    6400: (50, (16, 8, 5, 5), 3, 4),
    6656: (52, (16, 16, 13), 3, 4),
    6912: (54, (16, 8, 3, 3, 3), 3, 4),
    7168: (56, (8, 8, 8, 7), 3, 4),
    7424: (58, (16, 8, 29), 3, 4),
    7680: (60, (16, 16, 3, 5), 3, 4),
    7936: (62, (16, 8, 31), 3, 4),
    8448: (33, (16, 8, 3, 11), 4, 4),
    8704: (34, (16, 16, 17), 4, 4),
    8960: (35, (16, 8, 5, 7), 4, 4),
    9216: (36, (8, 8, 8, 3, 3), 4, 4),
    9472: (37, (16, 8, 37), 4, 4),
    9728: (38, (16, 16, 19), 4, 4),
    9984: (39, (16, 8, 3, 13), 4, 4),
    10240: (40, (16, 8, 8, 5), 4, 4),
    10496: (41, (16, 8, 41), 4, 4),
    10752: (42, (16, 16, 3, 7), 4, 4),
    11008: (43, (16, 8, 43), 3, 4),
    11264: (44, (8, 8, 8, 11), 3, 4),
    11520: (45, (16, 8, 3, 3, 5), 3, 4),
    11776: (46, (16, 16, 23), 3, 4),
    12032: (47, (16, 8, 47), 3, 4),
    12288: (48, (16, 16, 8, 3), 3, 4),
    12544: (49, (16, 8, 7, 7), 3, 4),
    12800: (50, (16, 16, 5, 5), 3, 4),
    13056: (51, (16, 8, 3, 17), 3, 4),
    13312: (52, (8, 8, 8, 13), 3, 4),
    13568: (53, (16, 8, 53), 3, 4),
    13824: (54, (16, 16, 3, 3, 3), 3, 4),
    14080: (55, (16, 8, 5, 11), 3, 4),
    14336: (56, (16, 8, 8, 7), 3, 4),
    14592: (57, (16, 8, 3, 19), 3, 4),
    14848: (58, (16, 16, 29), 3, 4),
    15104: (59, (16, 8, 59), 2, 4),
    15360: (60, (8, 8, 8, 3, 5), 3, 4),
    15616: (61, (16, 8, 61), 2, 4),
    15872: (62, (16, 16, 31), 3, 4),
}
# the wide plans' build units: csrc/wide_fft_frontend_<u>.cu holds the
# plans whose index in sorted(WIDE_PLANS) is u modulo WIDE_UNITS, each
# unit its own nvcc call (its own entry point, tsc_wide_fft_frontend_<u>)
WIDE_UNITS = 8


def odd_primes(m: int) -> tuple:
    """The odd prime factors of m, with multiplicity, smallest first."""
    out, q, f = [], m, 3
    while q % 2 == 0:
        q //= 2
    while q > 1:
        while q % f == 0:
            out.append(f)
            q //= f
        f += 2
    return tuple(out)


def wide_rule(n_fft: int) -> tuple:
    """(values a lane, radices) of the wide plan for n_fft = 256 m (see
    WIDE_PLANS)."""
    m, n = n_fft // 256, n_fft // 2
    odd = odd_primes(m)
    q = int(np.prod(odd)) if odd else 1
    values = q
    while 2 * values <= 64:
        values *= 2
    bits = (n // q).bit_length() - 1
    passes = -(-bits // 4)
    pow2 = tuple(2 ** (bits // passes + (i < bits % passes))
                 for i in range(passes))
    return values, pow2 + odd


def takes_wide_fft(n_fft: int) -> bool:
    """Whether the wide register FFT has a plan for n_fft."""
    return n_fft in WIDE_PLANS


@functools.lru_cache()
def wide_plan(n_fft: int) -> FftPlan:
    """The wide plan for n_fft (`WIDE_PLANS`): a frame over two or four
    warps."""
    if not takes_wide_fft(n_fft):
        raise ValueError(f"the wide register FFT takes n_fft = 256 m, m in "
                         f"17 .. 62 but 32, got {n_fft}")
    return build_plan(n_fft, *WIDE_PLANS[n_fft])


def wide_unit(n_fft: int) -> int:
    """The build unit (csrc/wide_fft_frontend_<u>.cu) of n_fft's plan."""
    return sorted(WIDE_PLANS).index(n_fft) % WIDE_UNITS


def swizzle(i):
    """The float2 slot of logical point i in a swizzled exchange."""
    return i ^ ((i >> 4) & 15)


def pass_maps(plan: FftPlan, p: int):
    """Pass p's index maps, each (lanes, ceil(values / R), R): the point
    butterfly l + lanes b reads as its input r, the point its output r goes
    to, and the twiddle row its input r is multiplied by (-1: none).  A
    butterfly j >= N / R (the last of some lanes of a wide plan) is none:
    its lane skips it."""
    radix, ns, n = plan.radices[p], plan.strides[p], plan.n
    j = (np.arange(plan.lanes)[:, None]
         + plan.lanes * np.arange(-(-plan.values // radix))[None, :])[..., None]
    r = np.arange(radix)[None, None, :]
    c = j % ns
    reads = j + r * (n // radix)
    writes = (j - c) * radix + c + r * ns
    tw = np.where(r > 0, plan.pass_offsets[p] + (r - 1) * ns + c, -1)
    return reads, writes, tw if ns > 1 else np.full_like(reads, -1)


def emulate_rfft(frames: np.ndarray, plan: FftPlan, tw: np.ndarray,
                 dft=None) -> np.ndarray:
    """(F, n_fft) real frames -> (F, n_fft / 2 + 1) bins through the
    kernel's passes (`pass_maps`) and untangle, in tw's precision (tw: the
    plan's twiddle rows as complex); `dft(v)` is the in-register DFT over
    the last axis (np.fft.fft by default)."""
    dt = tw.dtype
    dft = dft or (lambda v: np.fft.fft(v, axis=-1))
    n = plan.n
    buf = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(dt)
    for p in range(len(plan.radices)):
        reads, writes, tws = pass_maps(plan, p)
        real = reads[..., 0] < n // plan.radices[p]
        reads, writes, tws = reads[real], writes[real], tws[real]
        v = buf[:, reads]
        v = v * np.where(tws >= 0, tw[np.maximum(tws, 0)], 1).astype(dt)
        new = np.empty_like(buf)
        new[:, writes] = dft(v).astype(dt)
        buf = new
    k = np.arange(n // 2 + 1)
    a, b = buf[:, k], buf[:, (n - k) % n].conj()
    e, o = (a + b) / 2, -1j * (a - b) / 2
    wo = tw[plan.untangle_offset + k] * o
    x = np.empty((len(frames), n + 1), dt)
    x[:, k] = e + wo
    x[:, n - k] = (e - wo).conj()
    return x


@dataclasses.dataclass(frozen=True)
class FilterbankPlan:
    """The packed filterbank (`pack_filterbank`) split into one run of
    `chunk` consecutive weights a lane (odd, so that the lanes' weight reads
    fall in distinct banks).  A lane's run is cut where a filter ends into
    segments (first bin, first weight, count); a lane writes one partial sum
    a segment, then lane m adds filter m's partial sums in order.  `table`
    (int32) is what the kernel reads: lane_seg (lanes + 1), filt_seg (n_filt
    + 1), then the segments' rows."""

    packed: np.ndarray
    ranges: np.ndarray
    chunk: int
    segments: np.ndarray  # (n_seg, 3) int32: bin, weight offset, count
    lane_seg: np.ndarray  # (lanes + 1,) a lane's first segment
    filt_seg: np.ndarray  # (n_filt + 1,) a filter's first segment
    table: np.ndarray

    @property
    def n_seg(self) -> int:
        return len(self.segments)


def pack_filterbank(filt_t: np.ndarray):
    """The (n_filt, n_bins) filterbank as the kernels keep it in shared
    memory: each filter's bins from its first to its last nonzero, back to
    back in one float32 vector, and (n_filt, 3) int32 rows (lo, hi, offset)
    so that filter m's weight of bin k in [lo, hi) is packed[offset + k -
    lo].  An all-zero filter gets (0, 0, offset)."""
    ranges = np.zeros((filt_t.shape[0], 3), np.int32)
    chunks, offset = [], 0
    for m, row in enumerate(filt_t):
        nz = np.flatnonzero(row)
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        ranges[m] = lo, hi, offset
        chunks.append(row[lo:hi])
        offset += hi - lo
    packed = np.concatenate(chunks).astype(np.float32) if offset else \
        np.zeros(0, np.float32)
    return packed, ranges


def filterbank_plan(filt_t: np.ndarray, lanes: int) -> FilterbankPlan:
    packed, ranges = pack_filterbank(filt_t)
    n_packed, n_filt = len(packed), len(ranges)
    chunk = max(1, -(-n_packed // lanes))
    chunk += 1 - chunk % 2
    segs, seg_filt, lane_seg = [], [], []
    for lane in range(lanes):
        lane_seg.append(len(segs))
        e, end = min(lane * chunk, n_packed), min((lane + 1) * chunk, n_packed)
        for m, (lo, hi, off) in enumerate(ranges):
            a, b = max(e, off), min(end, off + hi - lo)
            if a < b:
                segs.append((lo + a - off, a, b - a))
                seg_filt.append(m)
    lane_seg.append(len(segs))
    seg_filt = np.asarray(seg_filt, np.int64)
    filt_seg = np.searchsorted(seg_filt, np.arange(n_filt + 1))
    segments = np.asarray(segs, np.int32).reshape(-1, 3)
    table = np.concatenate([np.asarray(lane_seg), filt_seg,
                            segments.ravel()]).astype(np.int32)
    return FilterbankPlan(packed=packed, ranges=ranges, chunk=chunk,
                          segments=segments,
                          lane_seg=np.asarray(lane_seg, np.int32),
                          filt_seg=filt_seg.astype(np.int32), table=table)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class FftLayout:
    """The kernel's shared memory for one config, region by region (bytes,
    each rounded up to 16), and what it lets an SM hold."""

    warps: int  # a block's
    twiddle: int
    weights: int
    table: int
    dct: int
    frames: int
    scratch: int
    feats: int
    smem_bytes: int
    blocks_per_sm: int
    warps_per_sm: int


def fft_layout(plan: FftPlan, fb: FilterbankPlan, n_filt: int, n_mfcc: int,
               n_features: int, warps: int | None = None) -> FftLayout:
    """Mirrors smem_layout() in csrc/register_fft.cuh, and launch_fft() in
    csrc/mfcc_frontend.cu (route ct's kernels take the warps from here):
    the twiddles and the packed weights (where the plan stages them), the
    filterbank table, the DCT, one buffer a frame slot (warps x
    frames_per_warp / warps_per_frame slots of `pitch` float2), one scratch
    row a slot (its partial sums, n_filt log-mel values, then
    warps_per_frame energy parts), and the window's (n_features, n_mfcc)
    coefficients; `warps` (the plan's by default, a wide plan's no more
    than its window's frames fill) a block, halved while that exceeds
    SMEM_OPTIN, down to one frame.  Blocks an SM: the least of shared
    memory, the warp limit and the launch bounds' registers."""
    wpf = plan.warps_per_frame

    def regions_of(warps):
        slots = warps * plan.frames_per_warp // wpf
        return tuple(_align16(r) for r in (
            8 * len(plan.twiddle) * plan.staged,
            4 * len(fb.packed) * plan.staged, 4 * len(fb.table),
            4 * n_filt * n_filt, 8 * slots * plan.pitch,
            4 * slots * (fb.n_seg + n_filt + wpf), 4 * n_features * n_mfcc))

    warps = warps or (plan.warps if wpf == 1 else
                      min(plan.warps, wpf * n_features))
    while sum(regions_of(warps)) > SMEM_OPTIN and warps > wpf:
        warps //= 2
    regions = regions_of(warps)
    smem = sum(regions)
    # the launch bounds cap a thread's registers at 65,536 / (32 max_warps
    # x min_blocks): that many blocks of max_warps warps fit whatever nvcc
    # allocates
    blocks = min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                 MAX_WARPS_PER_SM // warps,
                 plan.min_blocks * plan.max_warps // warps)
    return FftLayout(warps, *regions, smem_bytes=smem, blocks_per_sm=blocks,
                     warps_per_sm=blocks * warps)

