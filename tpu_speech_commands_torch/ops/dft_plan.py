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
  filter sums where the slot's filter changes.
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


def _align(v: int, m: int) -> int:
    return -(-v // m) * m


def ring_bytes(n_mfcc: int, stages: int) -> int:
    """ring_bytes() of the source: the ring, which the coefficients reuse
    after the last chunk, to a 1024-byte boundary."""
    return _align(max(stages * STAGE_BYTES, 4 * BM * n_mfcc), 1024)


def wgmma_table_bytes(n_pad: int, slots: int) -> int:
    """table_bytes() of the source: the filter slots' keys and weights."""
    return _align(4 * (n_pad // 2), 16) + _align(4 * (n_pad // 2) * slots, 16)


def wgmma_smem_bytes(wpb: int, win_pitch: int, n_filt: int, n_mfcc: int,
                     k_pad: int, table: int = 0, stages: int = STAGES,
                     power_tile: bool = False) -> int:
    """smem_bytes() of csrc/dft_wgmma.cu: 1024 bytes of alignment slack, the
    ring, the power tile (the ablation only), the audio, the filter sums,
    the k-offset table, the DCT, the filter slots where they fit (`table`
    bytes, `wgmma_table_bytes`), 2 x stages mbarriers for the ring and 4
    for the audio staging."""
    return (1024 + ring_bytes(n_mfcc, stages)
            + (_align(4 * BM * 65, 16) if power_tile else 0)
            + _align(2 * wpb * win_pitch, 16)
            + _align(4 * BM * ((n_filt + 1) | 1), 16)
            + _align(4 * (k_pad // 8), 16)
            + _align(4 * n_filt * n_filt, 16)
            + table + 8 * (2 * stages + 4))


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
