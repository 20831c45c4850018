"""The fast_math frontend's wgmma kernel (`csrc/dft_wgmma.cu`) emulated on
the CPU through its plan (`ops/dft_plan.py`): the source's constants and
shared memory against the plan, and one block's data moved by each of the
kernel's index maps (the staged audio read through ldmatrix, the TMA
stages in the 128-byte swizzle read back through wgmma descriptors, the
accumulator layout, the filterbank from the accumulators) against the
plain bf16 product, power and filter sums.

Tolerances: the A and B operands are bit for bit the plain version's bf16
values (exact); the emulated filter sums against the plain power times the
filterbank, rtol 1e-4 / atol 1e-9: f32 products in another summation order
(the plain product sums 1024 bf16 products in float64 here).  The CUDA
kernel against the plain version on the card: test_torch_gpu.py.
"""
import re

import numpy as np
import pytest
import torch

from tpu_speech_commands_torch.frontend import Frontend, frame_signal
from tpu_speech_commands_torch.frontend.filterbanks import filterbank_matrix
from tpu_speech_commands_torch.ops import _build, dft_plan
from tpu_speech_commands_torch.ops import fft_plan as fp
from tpu_speech_commands_torch.ops.frontend_kernel import (
    DFT_CEP_MIN_PRODUCTS, DFT_SMEM_MAX, DftConstants, _dft_smem_bytes,
    dft_cepstrum, dft_config_error, dft_layout, kernel_config_error,
    pack_filterbank)
from tpu_speech_commands_torch.params import ListenerParams

CONFIGS = {
    "mfcc": ({}, "mfcc"),
    "bark": ({}, "bark"),
    "use_delta": ({"use_delta": True}, "mfcc"),
    "window_t=0.05": ({"window_t": 0.05}, "mfcc"),
    "odd_hop": ({"hop_t": 0.03}, "mfcc"),
    "alt_512": ({"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                 "n_filt": 26, "n_mfcc": 13}, "mfcc"),
}
# the kernel's source and the ring's pieces it shares with the cepstrum
# kernel (its B descriptor among them)
SRC = "".join((_build.CSRC_DIR / name).read_text()
              for name in ("dft_wgmma.cu", "hopper_ring.cuh"))


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_source_constants_are_the_plan():
    """kBM, kBN, kBK, the consumers, the default ring and cluster, the
    descriptor's SBO and swizzle, and the last chunk's widths, read out of
    the source."""
    assert (_const("kBM"), _const("kBN"), _const("kBK"),
            _const("kConsumers")) == (dft_plan.BM, dft_plan.BN, dft_plan.BK,
                                      dft_plan.CONSUMERS)
    assert "#define TSC_DFT_STAGES (TSC_DFT_POWER_TILE ? 3 : 0)" in SRC
    assert f"constexpr int kMaxStages = {max(dft_plan.WGMMA_STAGES)};" in SRC
    assert re.search(rf"#define TSC_DFT_CLUSTER {dft_plan.CLUSTER}\n", SRC)
    assert f"((uint64_t)({dft_plan.SBO} >> 4) << 32)" in SRC
    assert "((uint64_t)1 << 62)" in SRC  # the 128-byte swizzle
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in SRC
    assert dft_plan.ROW == 2 * dft_plan.BK
    assert "cons.template run<kBN>(n_full, tail);" in SRC
    assert "cons.template run<16>(n_full, tail);" in SRC
    assert dft_plan.TAIL_WIDTHS == (16, dft_plan.BN)
    for n_pad, want in ((1040, 16), (528, 16), (1024, 0), (416, 128),
                        (1104, 128), (1072, 128), (80, 128)):
        assert dft_plan.tail_width(n_pad) == want
    assert "constexpr int kPPitch = 65;" in SRC


def test_source_shared_memory_terms_are_the_mirror():
    """smem_bytes() of the source, term by term, in the mirror's order: the
    shared sums of the block's windows' rows (all kBM with the power
    tile; a row `sums_pitch` floats), the DCT's n_mfcc - 1 columns (none
    in log-mel mode), log-mel mode's home table after the filter slots."""
    body = re.search(r"inline size_t smem_bytes\([^)]*\) \{(.*?)\n\}", SRC,
                     re.S).group(1)
    terms = ["1024 + ring_bytes(n_mfcc, stages)", "kPowerTile ? align16(sizeof(float) * kBM * kPPitch)",
             "sizeof(__nv_bfloat16) * (size_t)wpb * win_pitch",
             "sizeof(float) * (size_t)mel_rows(wpb, n_features) *\n"
             "                 sums_pitch(n_filt, n_bnd, direct)",
             "sizeof(int) * (size_t)(k_pad / 8)",
             "sizeof(float) * (size_t)n_filt * dct_cols(n_mfcc, logmel)",
             "+ table +", "home_bytes(n_filt, direct)",
             "sizeof(uint64_t) * (2 * stages + 4)"]
    at = [body.find(t) for t in terms]
    assert -1 not in at and at == sorted(at)
    rows = re.search(r"inline int mel_rows\(int wpb, int n_features\) \{(.*?)\n\}",
                     SRC, re.S).group(1)
    assert "return kPowerTile ? kBM : wpb * n_features;" in rows
    cols = re.search(r"inline int dct_cols\(int n_mfcc, int logmel\) \{(.*?)\n\}",
                     SRC, re.S).group(1)
    assert "return logmel ? 0 : n_mfcc - 1;" in cols
    ring = re.search(r"inline size_t ring_bytes\(int n_mfcc, int stages\) \{(.*?)\n\}",
                     SRC, re.S).group(1)
    assert "(size_t)stages * kStageBytes" in ring
    assert "sizeof(float) * (size_t)kBM * n_mfcc" in ring
    assert "align1024" in ring
    table = re.search(r"inline size_t table_bytes\(int n_pad, int slots\) \{(.*?)\n\}",
                      SRC, re.S).group(1)
    assert "sizeof(int) * (size_t)(n_pad / 2)" in table
    assert "sizeof(float) * (size_t)(n_pad / 2) * slots" in table


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_uses_the_mirror_and_fits(name):
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    lay = dft_layout(p, feature_type)
    slots = dft_plan.filter_slots(filterbank_matrix(p, feature_type).T,
                                  lay.wgmma_rows // 2).slots
    table = dft_plan.wgmma_table_bytes(lay.wgmma_rows, slots) if lay.table_smem else 0
    assert lay.smem_bytes == dft_plan.wgmma_smem_bytes(
        lay.wpb, lay.win_pitch, p.n_filt, p.n_mfcc, lay.k_pad, table,
        lay.stages, n_features=p.n_features) <= DFT_SMEM_MAX
    assert not lay.logmel and not dft_cepstrum(p, feature_type)
    # a ring of 5 stages fits beside every one of these configs' windows,
    # and then the mel (2-slot) filter slots, but not the bark (4-slot) ones
    assert lay.stages == 5
    assert lay.table_smem == (slots == 2)
    assert lay.wpb * p.n_features <= dft_plan.BM and lay.k_pad % 128 == 0
    # never fewer windows a block than the first design's
    assert lay.wpb >= dft_layout(p, feature_type, mma_sync=True).wpb


def test_takes_every_config_the_first_design_takes():
    """At one window a block the wgmma kernel's shared memory is never more
    than the mma.sync kernel's, over filters, coefficients, K and windows:
    so it refuses no config that one takes."""
    for n_filt, n_mfcc in ((13, 13), (20, 20), (40, 13), (80, 80), (200, 150)):
        for k_pad in (64, 448, 1024, 4096):
            for win_pitch in (1000, 16120, 60000):
                ours = dft_plan.wgmma_smem_bytes(1, win_pitch, n_filt, n_mfcc,
                                                 k_pad, n_features=128)
                theirs = _dft_smem_bytes(1, win_pitch, n_filt, n_mfcc, k_pad,
                                         0)
                assert ours <= theirs
    long = ListenerParams(buffer_t=8.0, window_t=0.128, hop_t=0.064,
                          n_fft=2048)
    assert "shared memory" in dft_config_error(long)
    assert "shared memory" in dft_config_error(long, mma_sync=True)


# the many-filter sweep of the fast_math kernel's layouts: n_filt 20 ..
# 512 at the default n_fft, 13 and 20 coefficients
MANY_FILTERS = (20, 40, 64, 100, 128, 129, 160, 200, 240, 300, 400, 512)


@pytest.mark.parametrize("n_mfcc", [13, 20])
def test_takes_every_filter_count_the_fft_kernel_takes(n_mfcc):
    """n_fft 1024, n_filt 20 .. 512: the kernel takes every config that the
    FFT kernel's route fft takes, in its mode from the config; a layout
    holds its DCT's n_mfcc - 1 columns (fused) or none (log-mel mode) and
    the filter sums of its windows' rows only, fits, and holds at least as
    many windows in log-mel mode as fused.  The default config stays
    fused; past the trimmed block's room, or DFT_CEP_MIN_PRODUCTS products
    a frame, log-mel mode."""
    for n_filt in MANY_FILTERS:
        p = ListenerParams(n_filt=n_filt, n_mfcc=n_mfcc)
        assert kernel_config_error(p) is None
        assert dft_config_error(p) is None, n_filt
        fused, logmel = dft_layout(p), dft_layout(p, logmel=True)
        for lay, mode in ((fused, False), (logmel, True)):
            slots = dft_plan.filter_slots(filterbank_matrix(p, "mfcc").T,
                                          lay.wgmma_rows // 2).slots
            table = dft_plan.wgmma_table_bytes(lay.wgmma_rows, slots) \
                if lay.table_smem else 0
            assert lay.logmel == mode
            assert lay.smem_bytes == dft_plan.wgmma_smem_bytes(
                lay.wpb, lay.win_pitch, n_filt, n_mfcc, lay.k_pad, table,
                lay.stages, n_features=p.n_features, logmel=mode,
                n_bnd=lay.n_bnd)
            assert lay.smem_bytes <= DFT_SMEM_MAX
            assert lay.wpb * p.n_features <= dft_plan.BM
        assert logmel.wpb >= fused.wpb
        cep = dft_cepstrum(p)
        assert cep == (fused.wpb < logmel.wpb
                       or n_filt * (n_mfcc - 1) >= DFT_CEP_MIN_PRODUCTS)
        assert DftConstants(p, "mfcc", "cpu").layout == (logmel if cep
                                                         else fused)
    assert not dft_cepstrum(ListenerParams())
    assert dft_cepstrum(ListenerParams(n_filt=240))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_filter_slots_hold_the_filterbank(name):
    """Slot l of bin b holds the weight of filter key + ((l - key) mod S):
    the slots rebuild the filterbank bit for bit; mel takes 2 slots, bark
    4."""
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    filt_t = filterbank_matrix(p, feature_type).T
    n_tab = dft_layout(p, feature_type).n_pad // 2
    slots = dft_plan.filter_slots(filt_t, n_tab)
    assert slots.slots == (4 if feature_type == "bark" else 2)
    rebuilt = np.zeros((p.n_filt, n_tab), np.float32)
    for b in range(n_tab):
        for l in range(slots.slots):
            f = dft_plan.slot_filter(int(slots.key[b]), l, slots.slots)
            if f < p.n_filt:
                rebuilt[f, b] += slots.w[b, l]
    np.testing.assert_array_equal(rebuilt[:, :p.n_fft_bins], filt_t)
    assert not rebuilt[:, p.n_fft_bins:].any()
    assert (np.diff(slots.key) >= 0).all()  # one run a slot and a filter
    with pytest.raises(ValueError, match="slots hold"):
        dft_plan.filter_slots(np.ones((6, 4), np.float32), 4)


@pytest.mark.parametrize("cluster", [1, 2])
def test_tma_stages_read_back_through_the_descriptors(cluster):
    """K-slices of every chunk of the default config's matrix, copied as
    the cluster's TMA boxes write them, read back through the wgmma
    descriptors of the four k16 blocks as the matrix, rows past it zero
    (the last chunk's 16 columns too); the stage without the swizzle, or
    with another SBO, does not."""
    p = ListenerParams()
    consts = DftConstants(p, "mfcc", "cpu")
    bits = consts.dft.view(torch.int16).numpy().view(np.uint16)
    n_pad, k_pad = bits.shape
    padded = np.zeros((-(-n_pad // dft_plan.BN) * dft_plan.BN, k_pad), np.uint16)
    padded[:n_pad] = bits
    for c in range(len(padded) // dft_plan.BN):
        for ks in (0, 7, k_pad // dft_plan.BK - 1):
            stage = dft_plan.tma_stage(bits, c, ks, cluster)
            want = padded[c * dft_plan.BN:(c + 1) * dft_plan.BN,
                          ks * dft_plan.BK:(ks + 1) * dft_plan.BK]
            for kk in range(dft_plan.BK // 16):
                got = dft_plan.wgmma_b(stage, kk, dft_plan.BN)
                np.testing.assert_array_equal(got, want[:, 16 * kk:16 * kk + 16])
                tail = dft_plan.wgmma_b(stage, kk, 16)
                np.testing.assert_array_equal(tail, want[:16, 16 * kk:16 * kk + 16])
    stage = dft_plan.tma_stage(bits, 0, 3, cluster)
    want = bits[:dft_plan.BN, 192:208]
    linear = dft_plan.swizzle128(np.arange(dft_plan.STAGE_BYTES))
    unswizzled = np.empty_like(stage)
    unswizzled[np.arange(dft_plan.STAGE_BYTES)] = stage[linear]
    assert not np.array_equal(dft_plan.wgmma_b(unswizzled, 0, dft_plan.BN), want)
    sbo = dft_plan.SBO
    try:
        dft_plan.SBO = 2048
        assert not np.array_equal(dft_plan.wgmma_b(stage, 0, 64), want[:64])
    finally:
        dft_plan.SBO = sbo


def _block(p, feature_type, audio):
    """One block's staged audio, row starts and layout at config p."""
    lay = dft_layout(p, feature_type)
    hop = p.hop_samples
    n_samples = audio.shape[1]
    first = 1 + (n_samples - p.window_samples) // hop - p.n_features
    x = torch.tensor(audio[:lay.wpb]).to(torch.bfloat16).float().numpy()
    smem = dft_plan.stage_audio(x, lay, first, hop, n_samples)
    rows = lay.wpb * p.n_features
    r = np.arange(dft_plan.BM)
    lw, f = r // p.n_features, r % p.n_features
    start = np.where(r < rows, lw * lay.win_pitch + f * lay.seg_pitch, 0)
    skoff = dft_plan.k_offsets(lay.k_pad, hop, lay.seg_pitch)
    return lay, smem, start, skoff, rows


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(31)
    t = np.arange(16000) / 16000.0
    rows = [0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(16000)
            for f in (440, 300, 1200, 2500)]
    return np.stack(rows).astype(np.float32)


def _frames(p, audio, lay):
    frames = frame_signal(torch.tensor(audio[:lay.wpb]), p.window_samples,
                          p.hop_samples)[..., -p.n_features:, :]
    return frames.reshape(-1, p.window_samples)


@pytest.mark.parametrize("name", ["mfcc", "odd_hop", "alt_512"])
def test_ldmatrix_fragments_are_the_frames(audio, name):
    """Each warp's A fragments, from its lanes' ldmatrix addresses into the
    staged audio, hold the bf16 frames of its 16 rows at every k16 block,
    bit for bit (rows past the block's windows read window 0's first
    frame, whose products are discarded)."""
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    lay, smem, start, skoff, rows = _block(p, feature_type, audio)
    frames = _frames(p, audio, lay).to(torch.bfloat16).float().numpy()
    k_eff = lay.k_eff
    for warp in range(dft_plan.CONSUMERS // 32):
        starts = start[16 * warp:16 * warp + 16]
        for k0 in range(0, lay.k_pad, 16):
            a = dft_plan.fragment_matrix(dft_plan.ldmatrix_a(smem, starts, skoff, k0))
            assert np.isfinite(a).all()  # never read a gap
            for i in range(16):
                r = 16 * warp + i
                want = np.zeros(16, np.float32)
                kk = np.arange(k0, k0 + 16)
                src = frames[r if r < rows else 0]
                ok = kk < k_eff
                want[ok] = src[kk[ok]]
                if k0 + 16 <= k_eff:
                    np.testing.assert_array_equal(a[i], want)


def _emulated_block(p, feature_type, audio, acc_map=dft_plan.acc_coords):
    """The filter sums of one block, every step through the plan's maps."""
    lay, smem, start, skoff, rows = _block(p, feature_type, audio)
    consts = DftConstants(p, feature_type, "cpu")
    bits = consts.dft_wgmma.view(torch.int16).numpy().view(np.uint16)
    a = np.zeros((dft_plan.BM, lay.k_pad), np.float32)
    for warp in range(dft_plan.CONSUMERS // 32):
        starts = start[16 * warp:16 * warp + 16]
        for k0 in range(0, lay.k_pad, 16):
            a[16 * warp:16 * warp + 16, k0:k0 + 16] = dft_plan.fragment_matrix(
                dft_plan.ldmatrix_a(smem, starts, skoff, k0))
    n_chunks = -(-lay.wgmma_rows // dft_plan.BN)
    b = np.zeros((n_chunks * dft_plan.BN, lay.k_pad), np.uint16)
    for c in range(n_chunks):
        for ks in range(lay.k_pad // dft_plan.BK):
            stage = dft_plan.tma_stage(bits, c, ks)
            for kk in range(dft_plan.BK // 16):
                k0 = ks * dft_plan.BK + 16 * kk
                b[c * dft_plan.BN:(c + 1) * dft_plan.BN, k0:k0 + 16] = \
                    dft_plan.wgmma_b(stage, kk, dft_plan.BN)
    bf = torch.tensor(b.view(np.int16)).view(torch.bfloat16).float().numpy()
    product = (a.astype(np.float64) @ bf.T.astype(np.float64)).astype(np.float32)
    # the accumulators as the threads hold them, back into (row, column)
    acc = np.full((dft_plan.BM, lay.wgmma_rows), np.nan, np.float32)
    for warp in range(dft_plan.CONSUMERS // 32):
        for lane in range(32):
            for reg in range(128):
                r, col = dft_plan.acc_coords(warp, lane, reg)
                rr, cc = acc_map(warp, lane, reg)
                for c in range(n_chunks):
                    if c * dft_plan.BN + col < lay.wgmma_rows:
                        acc[r, c * dft_plan.BN + col] = product[
                            rr, c * dft_plan.BN + cc]
    slots = dft_plan.filter_slots(filterbank_matrix(p, feature_type).T,
                                  lay.wgmma_rows // 2)
    mel = dft_plan.emulate_epilogue(acc, p.n_filt, slots, 1.0 / p.n_fft)
    return mel[:rows], lay


def _plain_sums(p, feature_type, audio, lay):
    power = Frontend(p, feature_type, "cpu", fast_math=True).power_from_frames(
        _frames(p, audio, lay)).double().numpy()
    filt = filterbank_matrix(p, feature_type).astype(np.float64)
    return np.concatenate([power @ filt, power.sum(-1, keepdims=True)], -1)


@pytest.mark.parametrize("name", ["mfcc", "bark", "window_t=0.05", "alt_512"])
def test_emulated_block_gives_the_plain_filter_sums(audio, name):
    """One block (4 windows: 120 rows; alt_512: 1 window of 98), every step
    through the plan's maps, against the plain fast_math power times the
    filterbank, with the energy."""
    kw, feature_type = CONFIGS[name]
    p = ListenerParams(**kw)
    got, lay = _emulated_block(p, feature_type, audio)
    want = _plain_sums(p, feature_type, audio, lay)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)


def test_a_wrong_accumulator_map_fails_the_emulation(audio):
    """The same emulation with re and im of a bin taken from the
    neighbouring rows (lane // 4 off by one) does not give the plain sums."""
    p = ListenerParams()

    def off_by_a_row(warp, lane, reg):
        r, c = dft_plan.acc_coords(warp, lane, reg)
        return (r + 1) % dft_plan.BM, c

    got, lay = _emulated_block(p, "mfcc", audio, off_by_a_row)
    want = _plain_sums(p, "mfcc", audio, lay)
    assert not np.allclose(got, want, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("n_fft", [1024, 1028, 400, 128])
def test_wgmma_matrix_is_the_matrix_in_chunk_bin_order(n_fft):
    """The wgmma kernel's matrix is the natural one (rows 2 k, 2 k + 1 the
    cos and sin of bin k; zero rows past it) with its rows reordered: chunk
    c's column col holds bin chunk_bin(c, col) (a quad lane's bins one run
    over all full chunks, the natural order in a last chunk of 16 columns),
    every natural row once."""
    p = ListenerParams(n_fft=n_fft, window_t=min(n_fft, 400) / 16000)
    consts = DftConstants(p, "mfcc", "cpu")
    lay = consts.layout
    order = dft_plan.column_order(lay.n_pad)
    assert len(order) == lay.wgmma_rows == dft_plan.wgmma_rows(lay.n_pad)
    assert sorted(order) == list(range(lay.wgmma_rows))
    natural = torch.cat([consts.dft, torch.zeros(
        lay.wgmma_rows - lay.n_pad, lay.k_pad, dtype=torch.bfloat16)])
    torch.testing.assert_close(consts.dft_wgmma, natural[order], rtol=0,
                               atol=0)
    n_full = lay.wgmma_rows // dft_plan.BN
    for row in range(lay.wgmma_rows):
        c, col = divmod(row, dft_plan.BN)
        b = dft_plan.chunk_bin(c, col, c < n_full, n_full)
        assert order[row] == 2 * b + col % 2
    # a lane's bins over the full chunks are one run: t 16 n_full + 0 ..
    lane = [dft_plan.chunk_bin(c, 8 * j + 2, True, n_full)
            for c in range(n_full) for j in range(16)]
    assert lane == list(range(16 * n_full, 32 * n_full))


def test_packed_filterbank_of_the_ablation_is_the_first_design_s():
    """The power-tile ablation reads the packed filterbank the mma.sync
    kernel reads: DftConstants keeps both forms of one filterbank."""
    p = ListenerParams()
    consts = DftConstants(p, "bark", "cpu")
    packed, ranges = pack_filterbank(filterbank_matrix(p, "bark").T)
    np.testing.assert_array_equal(consts.filt_packed.numpy(), packed)
    np.testing.assert_array_equal(consts.filt_range.numpy(), ranges)
    assert consts.slots == 4 and consts.bin_w.shape == (520, 4)


def test_ablation_switches_are_the_source_s():
    """Every -D switch of dev/dft_ablation.py names a macro the source
    defaults (`#ifndef`), and every variant builds a source of csrc/."""
    from tpu_speech_commands_torch.dev import dft_ablation

    for name, (source, flags, held) in dft_ablation.VARIANTS.items():
        assert (_build.CSRC_DIR / source).exists(), name
        for flag in flags:
            macro = re.fullmatch(r"-D(TSC_DFT_\w+)=\d+", flag).group(1)
            assert f"#ifndef {macro}\n#define {macro} " in SRC, (name, macro)
        assert held == ("_CUT" not in " ".join(flags)), name
