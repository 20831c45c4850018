"""The plan of `csrc/dft_wgmma.cu`, the fast_math frontend's wgmma kernel:
its tile constants, shared memory, filter slots, and a CPU emulation of its
index maps.

The kernel's constants (kBM, kBN, kBK, the ring's depths, the cluster) and
its `smem_bytes` have their twins here; `tests/test_torch_dft_plan.py`
reads them out of the source.  The emulation follows one block's data the
way the kernel moves it, each step by the map the hardware applies:
- `stage_audio` / `k_offsets`: the window's audio staged in hop segments
  (`frontend_kernel.dft_layout`), read through the k-offset table;
- `ldmatrix_a`: the A fragments of a warp's 16 rows, from the lanes'
  ldmatrix row addresses (the mma.m16n8k16 A layout, which each warp of a
  wgmma takes from registers);
- `tma_stage`: a 16 KB B stage as the cluster's TMA copies write it, each
  block's share of the rows in the 128-byte swizzle (`swizzle128`);
- `wgmma_b`: the B operand a wgmma descriptor (start, SBO, the k16 step)
  reads back out of the stage; `tail_width`: the N of the last chunk;
- `acc_coords`: the m64nNk16 accumulator layout, (warp, lane, register) ->
  (row, column); `chunk_bin` / `column_order`: which bin a chunk's column
  pair holds (a quad lane walks one run of consecutive bins over all
  chunks), the order the host builds the kernel's matrix in;
- `filter_slots` / `emulate_epilogue`: the filterbank from the
  accumulators, one running sum a slot and a row a thread, added into the
  filter sums where the slot's filter changes (fused mode, and log-mel
  mode's first design, `shared_sums`);
- `walk_lanes` / `filter_homes` / `emulate_logmel`: log-mel mode's
  design, where a filter that one quad lane's walk alone weighs leaves
  from that lane's registers (stored as it stands, logged in a pass over
  the block's rows after the walk), the few that several walks weigh are
  summed in a shared region of `n_bnd` floats a row, and a filter no bin
  weighs is written by the block's tail.
"""
from __future__ import annotations

import dataclasses

import numpy as np

BM = 128         # GEMM rows a block: two consumer warpgroups of 64
BN = 128         # DFT columns a chunk (64 bins): the wgmma N
BK = 64          # the K-slice: 128 bytes of bf16, one swizzle row
STAGES = 4       # the ring's B stages where 5 do not fit (wpb is chosen at 4)
WGMMA_STAGES = (4, 5)  # the depths the launch picks from: the most that fit
CLUSTER = 1      # blocks a cluster (2: each stage shared by TMA multicast)
CONSUMERS = 256  # two warpgroups; a producer warp beside them
STAGE_BYTES = BN * BK * 2
SBO = 1024       # bytes between 8-row groups of a stage (8 rows of 128 B)
ROW = 128        # bytes a B row of a stage (BK bf16)
TAIL_WIDTHS = (16, 128)  # the wgmma N of the last chunk
SLOTS = (2, 4)   # the kernel's instantiations: filters a bin may meet
QUAD = 4         # the lanes of a quad: each walks one run of bins (chunk_bin)
HOME_SHARED = 4  # a filter's home code from 4: its boundary sum k = code - 4
HOME_NONE = 255  # the home code of a filter no bin weighs
LOG_EPS = np.float32(2.220446049250313e-16)  # safe_log's clamp (kLogEps)
STAGE_CAP = 64   # entries of a warp's ring of finished filters (kStageCap)
LOGMEL_FINISH = 0  # where log-mel mode logs its finished filters (kFinish):
                   # 0 in one pass over the block's rows after the walk


def _align(v: int, m: int) -> int:
    return -(-v // m) * m


def ring_bytes(n_mfcc: int, stages: int) -> int:
    """ring_bytes() of the source: the ring, which the coefficients reuse
    after the last chunk, to a 1024-byte boundary."""
    return _align(max(stages * STAGE_BYTES, 4 * BM * n_mfcc), 1024)


def wgmma_table_bytes(n_pad: int, slots: int) -> int:
    """table_bytes() of the source: the filter slots' keys and weights."""
    return _align(4 * (n_pad // 2), 16) + _align(4 * (n_pad // 2) * slots, 16)


def sums_pitch(n_filt: int, n_bnd: int, direct: bool) -> int:
    """sums_pitch() of the source: the floats a row of the block's shared
    sums, the filter sums and the energy (fused, and log-mel mode's first
    design), or in log-mel mode the n_bnd boundary sums; odd, so that the
    rows of a quad's lanes fall in distinct banks."""
    return (n_bnd | 1) if direct else ((n_filt + 1) | 1)


def home_bytes(n_filt: int, direct: bool) -> int:
    """home_bytes() of the source: log-mel mode's home codes, a byte a
    filter (`filter_homes`)."""
    return _align(n_filt, 16) if direct else 0


def staging_bytes(direct: bool) -> int:
    """staging_bytes() of the source: log-mel mode's rings of finished
    filters, STAGE_CAP entries of 12 bytes a consumer warp, in the
    ablation that logs them there (LOGMEL_FINISH 3)."""
    return _align(CONSUMERS // 32 * STAGE_CAP * 12, 16) \
        if direct and LOGMEL_FINISH == 3 else 0


def wgmma_smem_bytes(wpb: int, win_pitch: int, n_filt: int, n_mfcc: int,
                     k_pad: int, table: int = 0, stages: int = STAGES,
                     power_tile: bool = False, *, n_features: int,
                     logmel: bool = False, shared_sums: bool = False,
                     n_bnd: int = 0) -> int:
    """smem_bytes() of csrc/dft_wgmma.cu: 1024 bytes of alignment slack, the
    ring, the power tile (the ablation only), the audio, the shared sums of
    the block's wpb x n_features rows (all BM with the power tile; a row
    `sums_pitch` floats: in log-mel mode only its n_bnd boundary sums,
    unless `shared_sums`, its first design), the k-offset table, the DCT's
    n_mfcc - 1 columns (none in log-mel mode), the filter slots where they
    fit (`table` bytes, `wgmma_table_bytes`), log-mel mode's home codes (and
    in an ablation its warps' rings, `staging_bytes`), 2 x stages mbarriers
    for the ring and 4 for the audio staging."""
    mel_rows = BM if power_tile else wpb * n_features
    dct_cols = 0 if logmel else n_mfcc - 1
    direct = logmel and not shared_sums
    return (1024 + ring_bytes(n_mfcc, stages)
            + (_align(4 * BM * 65, 16) if power_tile else 0)
            + _align(2 * wpb * win_pitch, 16)
            + _align(4 * mel_rows * sums_pitch(n_filt, n_bnd, direct), 16)
            + _align(4 * (k_pad // 8), 16)
            + _align(4 * n_filt * dct_cols, 16)
            + table + home_bytes(n_filt, direct) + staging_bytes(direct)
            + 8 * (2 * stages + 4))


@dataclasses.dataclass(frozen=True)
class FilterSlots:
    """Each bin's filters as the kernel's epilogue reads them: `slots` (2
    or 4) consecutive filters from `key[b]`, slot l holding the filter f =
    key + ((l - key) mod slots), its weight `w[b, l]` (0 where that filter
    has none at b).  A bin no filter covers keeps the key before it."""

    slots: int
    key: np.ndarray  # (n_tab,) int32
    w: np.ndarray    # (n_tab, slots) float32


def filter_slots(filt_t: np.ndarray, n_tab: int) -> FilterSlots:
    """The slot table of the (n_filt, n_bins) filterbank over n_tab >=
    n_bins bins (the rest weigh nothing).  Mel filters meet at most 2
    consecutive filters a bin, bark ones 4; ValueError for a filterbank
    whose filters at some bin span more than 4."""
    n_filt, n_bins = filt_t.shape
    span = 1
    first = np.zeros(n_tab, np.int64)
    prev = 0
    for b in range(n_tab):
        nz = np.flatnonzero(filt_t[:, b]) if b < n_bins else ()
        if len(nz):
            prev = int(nz[0])
            span = max(span, int(nz[-1]) - prev + 1)
        first[b] = prev
    slots = next((s for s in SLOTS if span <= s), None)
    if slots is None:
        raise ValueError(f"a bin meets filters {span} apart, more than "
                         f"{SLOTS[-1]} slots hold")
    w = np.zeros((n_tab, slots), np.float32)
    for b in range(min(n_bins, n_tab)):
        for l in range(slots):
            f = slot_filter(int(first[b]), l, slots)
            if f < n_filt:
                w[b, l] = filt_t[f, b]
    return FilterSlots(slots, first.astype(np.int32), w)


def slot_filter(key: int, slot: int, slots: int) -> int:
    """The filter of `slot` at a bin whose slots start at filter `key`."""
    return key + ((slot - key) & (slots - 1))


# ---- the index maps --------------------------------------------------------


def tail_width(n_pad: int) -> int:
    """The wgmma N of the chunk after the last full one: 16 where the
    n_pad % BN columns left are 16 (every n_fft 2^k), else the full width
    on the matrix's zero rows (0: no such chunk)."""
    left = n_pad % BN
    return next((w for w in TAIL_WIDTHS if left <= w), BN) if left else 0


def swizzle128(offset: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle of TMA and of a wgmma descriptor (layout type
    1) on byte offsets from a 1024-byte boundary: the 16-byte chunk (bits
    4-6) XOR bits 7-9."""
    offset = np.asarray(offset)
    return offset ^ (((offset >> 7) & 7) << 4)


def tma_stage(dft_bits: np.ndarray, chunk: int, ks: int,
              cluster: int = CLUSTER) -> np.ndarray:
    """The 16 KB stage of chunk `chunk`, K-slice `ks`, as bytes, written as
    the cluster's TMA copies write it: block r loads rows [r BN / cluster,
    (r + 1) BN / cluster) of the chunk (rows past the matrix read zero) to
    offset r BN / cluster x ROW bytes, each row's ROW bytes in the 128-byte
    swizzle.  dft_bits: the (n_pad, k_pad) bf16 matrix as uint16."""
    n_pad = dft_bits.shape[0]
    stage = np.zeros(STAGE_BYTES, np.uint8)
    box = BN // cluster
    for r in range(cluster):
        rows = chunk * BN + r * box + np.arange(box)
        tile = np.zeros((box, BK), np.uint16)
        ok = rows < n_pad
        tile[ok] = dft_bits[rows[ok], ks * BK:(ks + 1) * BK]
        logical = (r * box * ROW + np.arange(box)[:, None] * ROW
                   + np.arange(BK)[None, :] * 2)
        phys = swizzle128(logical)
        as_bytes = tile.astype("<u2").view(np.uint8).reshape(box, BK, 2)
        stage[phys] = as_bytes[..., 0]
        stage[phys + 1] = as_bytes[..., 1]
    return stage


def wgmma_b(stage: np.ndarray, kk: int, n: int) -> np.ndarray:
    """The (n, 16) bf16 bits (uint16) a wgmma reads as B (K-major, n x 16)
    from `stage` through the descriptor of the k16 block kk: start + 32 kk,
    8-row groups SBO apart, rows ROW bytes apart inside a group, then the
    swizzle."""
    rows = np.arange(n)[:, None]
    k = np.arange(16)[None, :]
    logical = 32 * kk + (rows // 8) * SBO + (rows % 8) * ROW + 2 * k
    phys = swizzle128(logical)
    return stage[phys].astype(np.uint16) | (stage[phys + 1].astype(np.uint16) << 8)


def chunk_bin(c: int, col: int, full: bool, n_full: int) -> int:
    """The bin whose re (col even) or im (col odd) column col of chunk c
    holds, n8 block j = col // 8, lane t = col % 8 // 2: in the n_full full
    chunks t 16 n_full + 16 c + j (each quad lane walks one run of
    consecutive bins over all of them), in a last chunk of 16 columns
    n_full BN / 2 + 4 j + t (chunk_bin<N> of the source)."""
    j, t = col // 8, col % 8 // 2
    return 16 * (t * n_full + c) + j if full else n_full * BN // 2 + 4 * j + t


def wgmma_rows(n_pad: int) -> int:
    """The wgmma kernel's matrix rows for a natural one of n_pad: n_pad
    where its last chunk is 16 columns (or none), else whole chunks (that
    chunk runs the full width, in the `chunk_bin` order)."""
    return n_pad if tail_width(n_pad) in (0, 16) else -(-n_pad // BN) * BN


def column_order(n_pad: int) -> np.ndarray:
    """(wgmma_rows(n_pad),) the natural matrix row (2 bin + re/im; n_pad and
    beyond: a zero row) of each wgmma matrix row: whole chunks in the
    `chunk_bin` order, a last chunk of 16 columns in the natural one."""
    rows = wgmma_rows(n_pad)
    n_full = rows // BN
    order = np.arange(rows)
    for c in range(n_full):
        for col in range(BN):
            order[c * BN + col] = 2 * chunk_bin(c, col, True, n_full) + col % 2
    return order


def acc_coords(warp: int, lane: int, reg: int) -> tuple[int, int]:
    """(row of the block, column of the chunk) of accumulator register
    `reg` of consumer thread (warp, lane): warp w holds rows 16 w .. 16 w +
    15 of the block (its warpgroup w // 4 the 64 rows from 64 (w // 4)),
    lane l rows l // 4 and l // 4 + 8, n8 block reg // 4, columns 2 (l % 4)
    and + 1."""
    row = 16 * warp + lane // 4 + 8 * ((reg >> 1) & 1)
    col = 8 * (reg // 4) + 2 * (lane % 4) + (reg & 1)
    return row, col


def k_offsets(k_pad: int, hop: int, seg_pitch: int) -> np.ndarray:
    """The kernel's k-offset table: element k (a multiple of 8) of a frame
    lies k + (k // hop) (seg_pitch - hop) elements from the frame's start."""
    k = np.arange(0, k_pad, 8)
    return k + (k // hop) * (seg_pitch - hop)


def stage_audio(x_bf16: np.ndarray, lay, first_frame: int, hop: int,
                n_samples: int) -> np.ndarray:
    """One block's staged audio (wpb x win_pitch, float32 values of bf16;
    NaN in the gaps): window lw's hop segment s at lw win_pitch + s
    seg_pitch, samples past the row zero.  x_bf16: (wpb, n_samples)."""
    smem = np.full(len(x_bf16) * lay.win_pitch, np.nan, np.float32)
    for lw, row in enumerate(x_bf16):
        for seg in range(lay.n_seg):
            g = (first_frame + seg) * hop + np.arange(hop)
            vals = np.where(g < n_samples, row[np.minimum(g, n_samples - 1)], 0)
            at = lw * lay.win_pitch + seg * lay.seg_pitch
            smem[at:at + hop] = vals
    return smem


def ldmatrix_a(smem: np.ndarray, row_start: np.ndarray, skoff: np.ndarray,
               k0: int) -> np.ndarray:
    """The (32, 4, 2) A fragment values one ldmatrix.x4 gives a warp for the
    k16 block at k0: lane l addresses row (l & 7) + 8 ((l >> 3) & 1) at
    k-half l >> 4 (element row_start[row] + skoff[k0 / 8 + half]), eight
    consecutive values; matrix q (lanes 8 q .. 8 q + 7's rows) goes to
    register q, lane m taking its row m // 4, values 2 (m % 4) and + 1.
    row_start: (16,) the element offset of each of the warp's rows."""
    lanes = np.arange(32)
    addr = (row_start[(lanes & 7) + 8 * ((lanes >> 3) & 1)]
            + skoff[k0 // 8 + (lanes >> 4)])
    rows8 = smem[addr[:, None] + np.arange(8)[None, :]]  # (32 addressers, 8)
    frag = np.empty((32, 4, 2), np.float32)
    for q in range(4):
        src = rows8[8 * q:8 * q + 8]  # matrix q: row i from lane 8 q + i
        frag[:, q, 0] = src[lanes // 4, 2 * (lanes % 4)]
        frag[:, q, 1] = src[lanes // 4, 2 * (lanes % 4) + 1]
    return frag


def fragment_matrix(frag: np.ndarray) -> np.ndarray:
    """The (16, 16) A tile that fragment (32, 4, 2) holds in the
    mma.m16n8k16 A layout: register 0 (row g, k 2t, 2t + 1), 1 (g + 8, ..),
    2 (g, 2t + 8, ..), 3 (g + 8, 2t + 8, ..), g = lane // 4, t = lane % 4."""
    a = np.full((16, 16), np.nan, np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            a[g + dr, 2 * t + dk:2 * t + dk + 2] = frag[lane, q]
    return a


def emulate_epilogue(acc: np.ndarray, n_filt: int, slots: FilterSlots,
                     inv_fft: float,
                     threads=range(CONSUMERS)) -> np.ndarray:
    """The filter sums (BM, n_filt + 1; column n_filt the energy) of one
    block from its full accumulators acc (BM, n_pad): each thread walks its
    bins chunk by chunk in the kernel's order, one running sum a slot and a
    row, flushed where the slot's filter changes, then the energy.  Rows
    outside `threads`' rows stay 0."""
    mel = np.zeros((BM, n_filt + 1), np.float64)
    n_pad = acc.shape[1]
    for tid in threads:
        warp, lane = divmod(tid, 32)
        r0, _ = acc_coords(warp, lane, 0)
        rows = (r0, r0 + 8)
        cur = [-1] * slots.slots
        run = np.zeros((slots.slots, 2), np.float32)
        energy = np.zeros(2, np.float32)

        def flush(l):
            if 0 <= cur[l] < n_filt:
                mel[rows[0], cur[l]] += run[l, 0]
                mel[rows[1], cur[l]] += run[l, 1]
            run[l] = 0

        n_chunks, n_full = -(-n_pad // BN), n_pad // BN
        for c in range(n_chunks):
            width = min(BN, n_pad - c * BN)
            for reg0 in range(0, 4 * (width // 8), 4):
                cols = [acc_coords(warp, lane, reg0 + e)[1] for e in range(2)]
                col = c * BN + cols[0]
                b = chunk_bin(c, cols[0], c < n_full, n_full)
                re = acc[list(rows), col]
                im = acc[list(rows), col + 1]
                p = ((re * re + im * im) * np.float32(inv_fft)).astype(np.float32)
                energy += p
                key = int(slots.key[b])
                for l in range(slots.slots):
                    f = slot_filter(key, l, slots.slots)
                    if f != cur[l]:
                        flush(l)
                        cur[l] = f
                    run[l] += p * slots.w[b, l]
        for l in range(slots.slots):
            flush(l)
        mel[rows[0], n_filt] += energy[0]
        mel[rows[1], n_filt] += energy[1]
    return mel


# ---- log-mel mode: finished filters leave from the registers ---------------


def walk_lanes(rows: int) -> np.ndarray:
    """(rows // 2,) the quad lane t whose walk holds each bin of a matrix
    of `rows` wgmma rows (`chunk_bin`: in the full chunks lane t walks bins
    16 t n_full .. 16 (t + 1) n_full - 1, in a last chunk of 16 columns
    bin n_full BN / 2 + 4 j + t)."""
    n_full = rows // BN
    lane = np.full(rows // 2, -1, np.int64)
    for c in range(-(-rows // BN)):
        for col in range(0, min(BN, rows - c * BN), 2):
            lane[chunk_bin(c, col, c < n_full, n_full)] = col % 8 // 2
    return lane


@dataclasses.dataclass(frozen=True)
class FilterHomes:
    """Where log-mel mode finishes each filter.  `home[f]`: the quad lane t
    (0 .. 3) whose walk alone weighs filter f, which stores safe_log of its
    running sum to the row when its slot releases f; HOME_SHARED + k for
    boundary filter k, which several lanes' walks weigh: their sums meet in
    the block's shared region (n_bnd floats a row); HOME_NONE for a filter
    no bin weighs.  `tail`: the filters the block's tail writes, the n_bnd
    boundary filters (from the shared sums), then those no bin weighs
    (safe_log(0))."""

    home: np.ndarray  # (n_filt,) uint8
    tail: np.ndarray  # (n_tail,) int32
    n_bnd: int


def filter_homes(slots: FilterSlots, n_filt: int, rows: int) -> FilterHomes:
    """The homes of the n_filt filters of a slot table over rows // 2 bins
    (`filter_slots`, `wgmma_rows`): a filter's lanes are the walks
    (`walk_lanes`) of the bins whose slots weigh it nonzero."""
    lane = walk_lanes(rows)
    lanes = [set() for _ in range(n_filt)]
    for b in range(rows // 2):
        for l in range(slots.slots):
            f = slot_filter(int(slots.key[b]), l, slots.slots)
            if f < n_filt and slots.w[b, l] != 0:
                lanes[f].add(int(lane[b]))
    bnd = [f for f in range(n_filt) if len(lanes[f]) > 1]
    if HOME_SHARED + len(bnd) > HOME_NONE:
        raise ValueError(f"{len(bnd)} boundary filters, more than a home "
                         f"code holds")
    home = np.full(n_filt, HOME_NONE, np.uint8)
    for f in range(n_filt):
        if len(lanes[f]) == 1:
            home[f] = next(iter(lanes[f]))
    for k, f in enumerate(bnd):
        home[f] = HOME_SHARED + k
    zero = [f for f in range(n_filt) if not lanes[f]]
    return FilterHomes(home, np.array(bnd + zero, np.int32), len(bnd))


def safe_log32(x) -> np.ndarray:
    """safe_log of the source on float32 values."""
    return np.log(np.maximum(np.float32(x), LOG_EPS)).astype(np.float32)


def emulate_logmel(acc: np.ndarray, n_filt: int, slots: FilterSlots,
                   homes: FilterHomes, inv_fft: float, rows: int,
                   warps=range(CONSUMERS // 32)) -> tuple[np.ndarray, np.ndarray]:
    """(out, writes): the log-mel rows (BM, n_filt + 1; column n_filt the
    log energy, NaN where nothing is written) that log-mel mode writes for
    one block from its full accumulators acc (BM, n_pad), and how many
    times each cell is written before the log pass.  Each consumer warp
    walks its lanes' bins in step, as the kernel does (`emulate_epilogue`'s
    walk): where a slot releases filter f, the owner lane (home[f] = t)
    stores its two rows' sums, a boundary filter's sums are added into the
    shared region, any other lane's (exactly 0: its walk does not weigh f)
    are dropped; then the quad's energies meet by two shuffles (xor 1, xor
    2) and lane 0 stores them; then the tail writes the boundary sums and 0
    for the filters no bin weighs, and the log pass takes the safe_log of
    the block's rows in place (LOGMEL_FINISH 0).  Rows from `rows` (the
    block's padding) write nothing."""
    raw = np.full((BM, n_filt + 1), np.nan, np.float32)
    writes = np.zeros((BM, n_filt + 1), np.int64)
    bnd = np.zeros((BM, max(homes.n_bnd, 1)), np.float32)
    n_pad = acc.shape[1]
    n_full = n_pad // BN
    n_slots = slots.slots
    home = homes.home.astype(np.int64)
    lanes = np.arange(32)
    t = lanes % QUAD

    def store(r, f, v):
        ok = r < rows
        raw[r[ok], f[ok]] = v[ok]
        np.add.at(writes, (r[ok], f[ok]), 1)

    for warp in warps:
        r0 = 16 * warp + lanes // QUAD  # acc_coords(warp, lane, 0)'s row
        pair = np.stack([r0, r0 + 8], 1)
        cur = np.full((32, n_slots), -1, np.int64)
        run = np.zeros((32, n_slots, 2), np.float32)
        energy = np.zeros((32, 2), np.float32)

        def release(l, mask):
            f = cur[:, l]
            valid = mask & (f >= 0) & (f < n_filt)
            code = np.where(valid, home[np.clip(f, 0, n_filt - 1)], -1)
            for lane in np.flatnonzero(valid & (code >= HOME_SHARED)
                                       & (code < HOME_NONE)):
                bnd[pair[lane], code[lane] - HOME_SHARED] += run[lane, l]
            own = np.flatnonzero(valid & (code == t))
            for i in range(2):
                store(pair[own, i], f[own], run[own, l, i])
            run[mask, l] = 0

        for c in range(-(-n_pad // BN)):
            full = c < n_full
            for j in range(min(BN, n_pad - c * BN) // 8):
                col = 8 * j + 2 * t
                b = 16 * (t * n_full + c) + j if full else \
                    n_full * BN // 2 + 4 * j + t
                re = acc[pair, (c * BN + col)[:, None]]
                im = acc[pair, (c * BN + col + 1)[:, None]]
                p = ((re * re + im * im) * np.float32(inv_fft)).astype(
                    np.float32)
                energy += p
                key = slots.key[b].astype(np.int64)
                for l in range(n_slots):
                    f = key + ((l - key) & (n_slots - 1))
                    moved = f != cur[:, l]
                    release(l, moved)
                    cur[moved, l] = f[moved]
                    run[:, l] += p * slots.w[b, l][:, None]
        for l in range(n_slots):
            release(l, np.ones(32, bool))
        quads = energy.reshape(8, QUAD, 2)
        total = (quads[:, 0] + quads[:, 1]) + (quads[:, 2] + quads[:, 3])
        for i in range(2):
            store(pair[::QUAD, i], np.full(8, n_filt), total[:, i])
    for k, f in enumerate(homes.tail):
        raw[:rows, f] = bnd[:rows, k] if k < homes.n_bnd else 0.0
        writes[:rows, f] += 1
    out = raw.copy()
    out[:rows] = safe_log32(raw[:rows])
    return out, writes
