"""The cepstrum kernel's plan and the DCT region of the register and wide FFT
bodies (csrc/cepstrum_wgmma.cu and its first design csrc/cepstrum.cu,
csrc/register_fft.cuh), on the CPU.

- the port's frontend at configs of many filters and coefficients against
  the JAX package's plain frontend, and the cepstrum kernel's emulated maps
  on the plain log-mel rows against JAX K1 (`make_fused_frontend`,
  dft_mode="ct", interpret mode), at this file's RTOL / ATOL (two f32
  chains that sum in another order, as tests/test_torch_frontend.py);
- `cepstrum_plan.emulate` (the kernel's blocks, whole-window tiles, column
  tiles of `n_tile`, chunks of 128 rows with the carried row, k8 steps of
  three TF32 products from the split rows and tables, time-major store) and
  `emulate_simt` (its first design's) against `cepstrum_plain` at 1e-5:
  float32 sums in another order, and the split's 2^-22 of each product;
- the kernel's column tiles (`n_tile`: a multiple of 8 up to 256, fewer
  than 8 columns past n_mfcc a tile) and its split tables (TF32 values,
  hi + lo within 2^-21 of the f32 table);
- the mirrors: `fft_plan.fft_layout` against smem_layout() evaluated from
  register_fft.cuh's text in every mode, and the tile constants against
  cepstrum_wgmma.cu's and cepstrum.cu's `#define`s;
- the body and mode each config of many filters and coefficients gets,
  from the config alone;
- the float64 features the card's checks at many filters use, against the
  port's float64 NumPy oracle.
The kernels on the card: tests/test_torch_gpu.py and chip_smoke.py.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.frontend import Frontend as JaxFrontend
from tpu_speech_commands.ops import make_fused_frontend
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands_torch.frontend.dsp import Frontend
from tpu_speech_commands_torch.frontend.filterbanks import (dct_t_matrix,
                                                            filterbank_matrix)
from tpu_speech_commands_torch.ops import _build, cepstrum_plan as cp
from tpu_speech_commands_torch.ops import ct_kernel
from tpu_speech_commands_torch.ops import fft_plan as fp
from tpu_speech_commands_torch.ops.frontend_kernel import (
    KernelConstants, MfccFrontend, fft_body, fft_cepstrum)
from tpu_speech_commands_torch.params import ListenerParams

RTOL, ATOL = 1e-4, 1e-4
GAIN = 0.7


def _params(n_fft, n_filt, n_mfcc, **kw):
    if n_fft & (n_fft - 1):
        kw.setdefault("window_t", n_fft / 16000)
    return dict(n_fft=n_fft, n_filt=n_filt, n_mfcc=n_mfcc, **kw)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(5)
    return (0.2 * rng.standard_normal((2, 16000))).astype(np.float32)


JAX_CASES = {
    "1024 x 128 x 20": _params(1024, 128, 20),
    "1024 x 240 x 20": _params(1024, 240, 20),
    "1024 x 128 x 128 deltas": _params(1024, 128, 128, use_delta=True),
    "4352 x 600 x 600": _params(4352, 600, 600),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_frontend_matches_the_jax_plain_frontend(audio, name):
    """`MfccFrontend` on the CPU at many filters and coefficients against
    the JAX package's plain frontend (`frontend/dsp.py::Frontend`), the
    gain applied to its audio first."""
    kw = JAX_CASES[name]
    p = ListenerParams(**kw)
    got = MfccFrontend(p, "mfcc", "cpu")(torch.tensor(audio), GAIN).numpy()
    want = np.asarray(JaxFrontend(JaxParams(**kw), "mfcc")(
        jnp.asarray(audio * np.float32(GAIN))))
    assert got.shape == want.shape == (2, p.n_features, p.feature_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _emulate(design, logmel, dct, n_mfcc, deltas=False, time_major=False):
    """The design's emulated maps on its own tables."""
    if design == "simt":
        return cp.emulate_simt(logmel, cp.extended_table(dct, n_mfcc), n_mfcc,
                               deltas, time_major)
    return cp.emulate(logmel, *cp.split_tables(dct, n_mfcc), n_mfcc, deltas,
                      time_major)


@pytest.mark.parametrize("design", ["wgmma", "simt"])
def test_emulated_cepstrum_matches_jax_k1(audio, design):
    """The cepstrum kernel's maps and split (`emulate`), and its first
    design's (`emulate_simt`), on the plain log-mel rows (`logmel_plain`,
    what the body writes in log-mel mode) against JAX K1 in interpret mode,
    at 128 filters and 128 coefficients (a config the cepstrum kernel
    serves) with deltas, two windows of int16 PCM."""
    kw = _params(1024, 128, 128, use_delta=True)
    p = ListenerParams(**kw)
    assert fft_cepstrum(p)
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    fused = make_fused_frontend(JaxParams(**kw), batch_tile=2, interpret=True,
                                dft_mode="ct", emit_deltas=True)
    want = np.asarray(fused(jnp.asarray(pcm), GAIN))
    logmel = cp.logmel_plain(Frontend(p, "mfcc", "cpu"), torch.tensor(pcm),
                             GAIN).numpy()
    got = _emulate(design, logmel, dct_t_matrix(128), 128, deltas=True)
    assert got.shape == want.shape == (2, p.n_features, 256)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


EMULATION_CASES = {
    # batch, frames, filters, coefficients
    "windows split over tiles unevenly": (7, 23, 40, 13),
    "a window over two chunks": (3, 150, 24, 10),
    "one frame a window": (130, 1, 20, 20),
    "two column tiles": (5, 30, 200, 130),
    "two kernel column tiles": (3, 23, 300, 300),
}


@pytest.mark.parametrize("design", ["wgmma", "simt"])
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("deltas", [False, True])
@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_emulation_matches_plain(name, deltas, time_major, design):
    """`emulate` (the kernel) and `emulate_simt` (its first design) write
    every output once and agree with `cepstrum_plain`: 5 + 2 windows of 23
    frames (wpb 5), a window of 150 frames in chunks of 128 and 22 rows (the
    carried row gives the first delta of the second), one-frame windows 128
    a tile, 130 coefficients over the first design's two column tiles, 300
    over the kernel's two of 152."""
    batch, n_feat, n_filt, n_mfcc = EMULATION_CASES[name]
    rng = np.random.default_rng(batch + n_feat)
    logmel = (3 * rng.standard_normal((batch, n_feat, n_filt + 1))
              ).astype(np.float32)
    dct = dct_t_matrix(n_filt)
    got = _emulate(design, logmel, dct, n_mfcc, deltas, time_major)
    want = cp.cepstrum_plain(torch.tensor(logmel), torch.tensor(dct), n_mfcc,
                             deltas, time_major).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_n_tile_fits_the_coefficients():
    """For every n_mfcc of 1-600 the kernel's column tile is one of TILES
    (multiples of 8 up to 256, each an instantiation), its tiles hold fewer
    than 8 columns past n_mfcc each, and no tile is all padding: 24 columns
    at 20 coefficients, 3 x 200 at 600."""
    assert cp.TILES == tuple(range(8, cp.MAX_TILE_N + 1, 8))
    assert cp.MAX_TILE_N <= 256
    for n_mfcc in range(1, 601):
        tile = cp.n_tile(n_mfcc)
        n_pad, k_pad = cp.table_shape(600, n_mfcc)
        n_tiles = n_pad // tile
        assert tile in cp.TILES and n_pad == n_tiles * tile, n_mfcc
        assert n_pad - n_mfcc < 8 * n_tiles, n_mfcc
        assert n_pad - tile < n_mfcc <= n_pad, n_mfcc
        assert k_pad == 608
    assert (cp.n_tile(20), cp.table_shape(240, 20)) == (24, (24, 256))
    assert (cp.n_tile(600), cp.table_shape(600, 600)) == (200, (600, 608))
    assert (cp.n_tile(8), cp.n_tile(9)) == (8, 16)


@pytest.mark.parametrize("n_filt,n_mfcc", [(20, 20), (240, 20), (600, 600),
                                           (40, 13)])
def test_split_tables_hold_tf32_values(n_filt, n_mfcc):
    """hi and lo are (n_pad, k_pad), the extended table transposed; every
    value has its low 13 bits zero (TF32), and hi + lo is the f32 table
    within 2^-21 of each value (|lo| <= 2^-11 |hi|)."""
    dct = dct_t_matrix(n_filt)
    hi, lo = cp.split_tables(dct, n_mfcc)
    ext = cp.extended_table(dct, n_mfcc)
    n_pad, k_pad = cp.table_shape(n_filt, n_mfcc)
    assert hi.shape == lo.shape == (n_pad, k_pad)
    assert hi.dtype == lo.dtype == np.float32
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    want = np.zeros((k_pad, n_pad), np.float32)
    rows, cols = min(k_pad, ext.shape[0]), min(n_pad, ext.shape[1])
    want[:rows, :cols] = ext[:rows, :cols]
    got = hi.astype(np.float64) + lo.astype(np.float64)
    np.testing.assert_allclose(got, want.T.astype(np.float64), rtol=2.0 ** -21,
                               atol=0)
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(hi)).all()
    assert hi[0, n_filt] == 1 and np.count_nonzero(hi[0]) == 1
    x = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12], np.float32)
    np.testing.assert_array_equal(cp.tf32_rna(x),
                                  [1 + 2 ** -10, -(1 + 2 ** -10), 1])


def test_extended_table_carries_the_energy_into_column_zero():
    """ext is (k_pad, n_pad), multiples of BK and BN; column 0 is 1 at row
    n_filt (the log energy) and 0 elsewhere; columns 1 .. n_mfcc - 1 the
    DCT's; every other entry 0."""
    dct = dct_t_matrix(40)
    ext = cp.extended_table(dct, 13)
    assert ext.shape == cp.padded_shape(40, 13) == (48, 128)
    assert ext[40, 0] == 1 and np.count_nonzero(ext[:, 0]) == 1
    np.testing.assert_array_equal(ext[:40, 1:13], dct[:, 1:13])
    assert np.count_nonzero(ext) == 1 + np.count_nonzero(dct[:, 1:13])
    assert cp.windows_per_block(23) == 5 and cp.windows_per_block(150) == 1


def test_tile_constants_are_the_source_defines():
    """cepstrum.cu's TSC_CEP_* are the plan's tile; its shared memory, the
    ring or the staged tile and a carried row, is 66,560 bytes: three
    blocks an SM by shared memory, two by the launch bounds."""
    src = (_build.CSRC_DIR / "cepstrum.cu").read_text()
    defines = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"#define TSC_CEP_(\w+) (\d+)", src)}
    assert defines == {"BM": cp.BM, "BN": cp.BN, "BK": cp.BK,
                       "THREADS": cp.THREADS, "APAD": cp.A_PAD}
    assert "__launch_bounds__(TSC_CEP_THREADS, 2)" in src
    assert cp.smem_bytes() == 4 * (128 * 129 + 128) == 66560
    assert fp.SMEM_PER_SM // (cp.smem_bytes() + fp.SMEM_RESERVED) == 3


def test_wgmma_tile_constants_are_the_source_defines():
    """cepstrum_wgmma.cu's TSC_CEPW_* are the plan's tile, its launch bounds
    the plan's blocks an SM, and its ring the plan's: at least three stages
    at every tile, each block within its share of the SM (two blocks up to
    32 columns, else one) and the staged tile within the ring."""
    src = (_build.CSRC_DIR / "cepstrum_wgmma.cu").read_text()
    defines = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"#define TSC_CEPW_(\w+) (\d+)", src)}
    assert defines == {"BM": cp.TILE_M, "BK": cp.TILE_K,
                       "MAX_BN": cp.MAX_TILE_N, "APITCH": cp.A_PITCH,
                       "THREADS": cp.WG_THREADS,
                       "MAX_STAGES": cp.MAX_STAGES,
                       "TWO_BLOCK_BN": cp.TWO_BLOCK_TILE,
                       "CUT": 0}  # the ablation's switch: no cut shipped
    assert "__launch_bounds__(TSC_CEPW_THREADS, Tile<BN>::kBlocks)" in src
    assert "kBlocks = BN <= TSC_CEPW_TWO_BLOCK_BN ? 2 : 1" in src
    assert "kStageBytes = 2 * kTableBytes + kBM * kAPitch * 4" in src
    assert "return 1024 + 4 * BN + 8 * (2 * stages + 1)" in src
    assert {int(n) for n in re.findall(r"TSC_WGMMA_TF32\(\d+, (\d+)\)",
                                       src)} == set(cp.TILES)
    assert cp.TILE_M == cp.BM and cp.A_PITCH == cp.TILE_K + 4
    for tile in cp.TILES:
        blocks = cp.blocks_per_sm(tile)
        assert 3 <= cp.ring_stages(tile) <= cp.MAX_STAGES
        assert blocks * (cp.wgmma_smem_bytes(tile) + fp.SMEM_RESERVED) <= \
            fp.SMEM_PER_SM
        assert cp.wgmma_smem_bytes(tile) <= fp.SMEM_OPTIN
        assert 4 * cp.TILE_M * (tile + 4) <= \
            cp.ring_stages(tile) * cp.stage_bytes(tile)
        assert cp.stage_bytes(tile) % 1024 == 0
    assert [cp.ring_stages(t) for t in (24, 200, 224)] == [4, 3, 3]
    assert cp.wgmma_smem_bytes(200) == 210776


def _source_smem_layout():
    """smem_layout() of register_fft.cuh as a Python function of (P, its
    arguments), evaluated from the source's text."""
    src = (_build.CSRC_DIR / "register_fft.cuh").read_text()
    m = re.search(r"SmemLayout smem_layout\(([^)]*)\) \{\n(.*?)\n\}", src,
                  re.S)
    params = [a.split()[-1] for a in m.group(1).split(",")]
    body = []
    for line in m.group(2).splitlines():
        line = line.strip().rstrip(";")
        if line.startswith("SmemLayout s") or not line:
            continue
        line = line.replace("const size_t ", "").replace(
            "static_cast<size_t>(n_warps)", "n_warps")
        line = re.sub(r"\(P::kStaged \? (.*) : 0\)", r"((\1) if P.kStaged else 0)",
                      line)
        line = (line.replace("P::", "P.").replace("sizeof(float2)", "8")
                .replace("sizeof(float)", "4").replace("sizeof(int)", "4")
                .replace("s.", "s_").replace(" / ", " // "))
        body.append("    " + line.replace("return s", "return s_total"))
    env = {"align16": lambda n: -(-n // 16) * 16}
    body = [ln if "return" not in ln else
            "    return (s_twiddle, s_packed, s_table, s_dct, s_frames, "
            "s_scratch, s_feats, s_total)" for ln in body]
    exec(f"def smem_layout(P, {', '.join(params)}):\n" + "\n".join(body), env)
    assert "a.logmel ? 0 : a.dct_cols, a.logmel ? 0 : a.n_mfcc" in src
    return env["smem_layout"]


class _P:
    """A plan's compile-time constants as register_fft.cuh's RegisterPlan
    names them."""

    def __init__(self, plan):
        self.kFpw, self.kWpf = plan.frames_per_warp, plan.warps_per_frame
        self.kStaged, self.kNtw = plan.staged, len(plan.twiddle)
        self.kL, self.kPitch = plan.lanes, plan.pitch


@pytest.mark.parametrize("mode", ["trimmed", "full", "logmel",
                                  "logmel_partial_sums"])
def test_fft_layout_mirrors_the_source(mode):
    """fft_layout's regions, fused with the trimmed (n_filt, n_mfcc - 1) or
    the whole DCT, or in log-mel mode (no DCT, no coefficients; its tail on
    the log-mel filterbank plan, or its first tail on the fused one), are
    the offsets smem_layout() computes from the source's text, at the
    register, mixed-radix and wide plans and several filter and coefficient
    counts (the tail's weights are its step tables', chunk a lane);
    table_ints() and slot_floats() of the source are fft_plan's table and
    `slot_floats`."""
    smem_layout = _source_smem_layout()
    src = (_build.CSRC_DIR / "register_fft.cuh").read_text()
    assert ("return P::kL + 1 + n_filt + 1 + (logmel == kLogmelRows ? 4 : 3) "
            "* n_seg;") in src
    assert ("return logmel == kLogmelRows ? row_stage(n_filt) + ((P::kL + "
            "P::kWpf + 3) & ~3)\n                               : n_seg + "
            "n_filt + P::kWpf;") in src
    assert "inline int row_stage(int n_filt) { return (n_filt + 7) & ~3; }" \
        in src
    assert re.search(r"enum Logmel : int \{ kFused = 0, kLogmelRows = "
                     rf"{cp.LOGMEL_ROWS}, kLogmelPartial = "
                     rf"{cp.LOGMEL_PARTIAL} \}};", src)
    cases = [(fp.fft_plan(1024), 1024), (fp.fft_plan(4096), 4096),
             (fp.mixed_plan(768), 768), (fp.wide_plan(4352), 4352),
             (fp.fft_wide_plan(8192), 8192)]
    logmel = mode.startswith("logmel")
    rows = mode == "logmel"
    for plan, n_fft in cases:
        for n_filt, n_mfcc in ((20, 20), (40, 13), (128, 1), (300, 60)):
            p = ListenerParams(**_params(n_fft, n_filt, n_mfcc))
            fb = fp.filterbank_plan(filterbank_matrix(p, "mfcc").T, plan.lanes)
            lay = fp.fft_layout(plan, fb, n_filt, n_mfcc, p.n_features,
                                plan.warps_per_frame,
                                full_dct=mode == "full", cepstrum=logmel,
                                partial_sums=mode == "logmel_partial_sums")
            used = fp.logmel_filterbank(fb, plan.lanes) if rows else fb
            assert len(used.table) == (plan.lanes + 1 + n_filt + 1
                                       + (4 if rows else 3) * used.n_seg)
            cols = n_filt if mode == "full" else 0 if logmel else n_mfcc - 1
            # the tail stages its step tables' weights, chunk a lane
            n_weights = used.chunk * plan.lanes if rows else len(used.packed)
            got = smem_layout(_P(plan), lay.warps, n_weights,
                              len(used.table), n_filt, cols,
                              0 if logmel else n_mfcc, p.n_features,
                              fp.slot_floats(plan, used.n_seg, n_filt, rows))
            regions = (lay.twiddle, lay.weights, lay.table, lay.dct,
                       lay.frames, lay.scratch, lay.feats)
            assert got == tuple(np.cumsum((0,) + regions)), (n_fft, n_filt)
            assert lay.dct == -(-4 * n_filt * cols // 16) * 16


TABLE = {  # (n_fft, n_filt, n_mfcc): body, cepstrum, blocks x warps an SM
    (1024, 20, 20): ("register", False, (4, 8)),
    (1024, 64, 20): ("register", True, (4, 8)),
    (1024, 80, 40): ("register", True, (4, 8)),
    (1024, 128, 20): ("register", True, (4, 8)),
    (1024, 128, 128): ("register", True, (4, 8)),
    (1024, 240, 20): ("register", True, (4, 8)),  # 3 before the row tail
    (768, 230, 20): ("register", True, (2, 4)),
    (4352, 300, 20): ("wide", True, (4, 4)),
    (4352, 300, 300): ("wide", True, (4, 4)),
    (4352, 512, 512): ("wide", True, (4, 4)),
    (4352, 600, 600): ("wide", True, (4, 4)),
}


@pytest.mark.parametrize("key", sorted(TABLE))
def test_body_and_mode_come_from_the_config(key):
    """Every config of the table takes the register or wide body, fused
    where its trimmed block keeps all the warps an SM that log-mel mode
    holds and its DCT has fewer than CEP_MIN_PRODUCTS products a frame
    (20 x 20 at 1024: 380), else with the cepstrum kernel (80 x 40 at 1024:
    24 of 32 warps; 128 x 128: 8 of 32; 64 x 20 at 1024 and 230 x 20 at 768
    keep their warps, at 1,216 and 4,370 products; 300-600 coefficients at
    4352: no fused block fits); never the radix-2 body or the CT split."""
    body, cepstrum, (blocks, warps) = TABLE[key]
    p = ListenerParams(**_params(*key))
    fe = MfccFrontend(p, "mfcc", "cpu")
    assert (fe.body, fe.cepstrum) == (body, cepstrum)
    if fe.route == "fft":
        assert fft_body(p) == body and fft_cepstrum(p) == cepstrum
        consts = KernelConstants(p, "mfcc", "cpu")
    else:
        assert ct_kernel.ct_body(p) == body
        assert ct_kernel.ct_cepstrum(p) == cepstrum
        consts = ct_kernel.CtConstants(p, "mfcc", "cpu")
    assert consts.cepstrum == cepstrum
    lay = consts.layout
    assert (lay.blocks_per_sm, lay.warps) == (blocks, warps)
    assert lay == consts.layout_for(p, cepstrum=cepstrum)
    assert (lay.dct == 0) == cepstrum or p.n_mfcc == 1


def test_default_layout_keeps_four_blocks_of_eight_warps():
    """The default config: fused, its DCT region the 20 x 19 columns the
    output uses (1,520 bytes, 80 fewer than the whole table), 49,568 bytes a
    block, 4 blocks of 8 warps an SM; every other region as with the whole
    table."""
    p = ListenerParams()
    consts = KernelConstants(p, "mfcc", "cpu")
    lay, full = consts.layout, consts.layout_for(p, full_dct=True)
    assert not consts.cepstrum and (lay.blocks_per_sm, lay.warps) == (4, 8)
    assert (lay.dct, full.dct) == (1520, 1600)
    assert (lay.smem_bytes, full.smem_bytes) == (49568, 49648)
    assert lay.warps_per_sm == full.warps_per_sm == 32
    for region in ("twiddle", "weights", "table", "frames", "scratch",
                   "feats"):
        assert getattr(lay, region) == getattr(full, region)
    np.testing.assert_array_equal(consts.dct_trim.numpy(),
                                  dct_t_matrix(20)[:, 1:20])


@pytest.mark.parametrize("kw", [{}, _params(1024, 128, 40, use_delta=True),
                                _params(4352, 300, 60)])
def test_exact_features_are_the_float64_oracle(kw):
    """`dev.cepstrum_ablation.exact_features`, the float64 features the
    card's checks at many filters hold the kernels to, against the port's
    float64 NumPy oracle (frontend/numpy_ref.py) on two speech windows,
    tail-aligned, deltas after the trim; at atol 1e-5 / rtol 1e-6 (the
    oracle builds its filterbank in float64, the reference from the
    kernels' float32 weights, which differ in the eighth digit)."""
    from tpu_speech_commands_torch.dev import cepstrum_ablation
    from tpu_speech_commands_torch.frontend import numpy_ref

    p = ListenerParams(**kw)
    audio = cepstrum_ablation.speech_audio(2, p.max_samples, 3, "cpu")
    got = cepstrum_ablation.exact_features(p, audio, GAIN)[0].numpy()
    for b in range(2):
        x = audio[b].numpy().astype(np.float64) * np.float32(GAIN)
        want = numpy_ref.vectorize_raw(x, p)[-p.n_features:]
        if p.use_delta:
            want = numpy_ref.add_deltas(want)
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-5)
