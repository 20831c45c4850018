"""Log-mel mode of the fast_math frontend's wgmma kernel (`csrc/dft_wgmma.cu`,
kDirect), emulated on the CPU through its plan (`ops/dft_plan.py`): a
filter that one quad lane's walk alone weighs leaves from that lane's
registers, the few boundary filters meet in a shared region of n_bnd
floats a row, and the block's tail writes those and the filters no bin
weighs.

- the mirrors: the source's home codes, shared-sums pitch, home table,
  the log pass after the walk and the energy shuffles, read out of its
  text, against the plan's;
- the walk and the homes: each bin walked by one quad lane, each filter
  owned by the lane whose bins alone weigh it, few boundary filters;
- the layouts: 4 windows a block at n_fft 1024 for 20-512 filters, mel
  and bark, every layout under DFT_SMEM_MAX; the mode rule
  (`dft_cepstrum`, `DFT_CEP_MIN_PRODUCTS`) pinned;
- the emulated rows (`emulate_logmel`: each warp's lanes in step, the
  owner lanes' stores, the tail, then the log pass): every cell of a
  block's rows written exactly once before the log pass; held,
  with the plain fast_math rows, to the float64 rows of the same bf16
  frames and DFT matrix (`exact_logmel`) within the f32 feature bound plus
  the rounding slack; and through `cepstrum_plan`'s
  plain DCT, with JAX's `make_fused_frontend(fast_math=True,
  dft_mode="dense")` in interpret mode, to the float64 features
  (`exact_features`) within the same bound: from 80 filters at n_fft 1024
  a filter covers one bin, and a bare f32-against-f32 check fails there
  (`dev.cepstrum_ablation.check_conditioned`).
The kernel on the card: tests/test_torch_gpu.py and chip_smoke.py.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.ops import make_fused_frontend
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands_torch.dev import cepstrum_ablation as ca
from tpu_speech_commands_torch.frontend import Frontend, frame_signal
from tpu_speech_commands_torch.frontend.filterbanks import (dct_t_matrix,
                                                            filterbank_matrix)
from tpu_speech_commands_torch.ops import _build, cepstrum_plan, dft_plan
from tpu_speech_commands_torch.ops.frontend_kernel import (
    DFT_CEP_MIN_PRODUCTS, DFT_SMEM_MAX, DftConstants, dft_cepstrum,
    dft_config_error, dft_layout)
from tpu_speech_commands_torch.params import ListenerParams

SRC = (_build.CSRC_DIR / "dft_wgmma.cu").read_text()
# n_filt at the default n_fft: the many-filter sweep of the layouts
MANY_FILTERS = (20, 32, 40, 64, 80, 96, 128, 129, 160, 200, 240, 300, 400,
                512)
GAIN = 0.8


def _body(signature: str) -> str:
    return re.search(re.escape(signature) + r"[^{]*\{(.*?)\n\}", SRC,
                     re.S).group(1)


def test_source_home_codes_and_regions_are_the_plan():
    """kHomeShared / kHomeNone, sums_pitch(), home_bytes() and
    staging_bytes() (kStageCap, the default TSC_DFT_LOGMEL_FINISH), their
    terms in smem_bytes(), the log pass after the walk and the order of
    the energy's shuffles, from the source's text."""
    assert f"constexpr int kHomeShared = {dft_plan.HOME_SHARED};" in SRC
    assert f"constexpr int kHomeNone = {dft_plan.HOME_NONE};" in SRC
    assert ("return direct ? (n_bnd | 1) : mel_pitch(n_filt);"
            in _body("inline int sums_pitch("))
    assert ("return direct ? align16((size_t)n_filt) : 0;"
            in _body("inline size_t home_bytes("))
    assert ("return direct && kStaged ? align16((size_t)(kConsumers / 32) * "
            "kStageCap * 12) : 0;" in _body("inline size_t staging_bytes("))
    assert f"constexpr int kStageCap = {dft_plan.STAGE_CAP};" in SRC
    assert (f"#ifndef TSC_DFT_LOGMEL_FINISH\n#define TSC_DFT_LOGMEL_FINISH "
            f"{dft_plan.LOGMEL_FINISH}\n") in SRC
    assert "constexpr bool kStaged = kFinish == 3;" in SRC
    smem = _body("inline size_t smem_bytes(")
    terms = ["sums_pitch(n_filt, n_bnd, direct)", "+ table +",
             "home_bytes(n_filt, direct)", "staging_bytes(direct)",
             "sizeof(uint64_t) * (2 * stages + 4)"]
    at = [smem.find(t) for t in terms]
    assert -1 not in at and at == sorted(at)
    shuffles = re.findall(r"e0 \+= __shfl_xor_sync\(0xffffffffu, e0, (\d)\);",
                          SRC)
    assert shuffles == ["1", "2"]  # (e0 + e1) + (e2 + e3), as emulated
    for n_filt, n_bnd in ((240, 5), (20, 6), (512, 0)):
        assert dft_plan.sums_pitch(n_filt, n_bnd, True) == n_bnd | 1
        assert dft_plan.sums_pitch(n_filt, n_bnd, False) == (n_filt + 1) | 1
        assert dft_plan.home_bytes(n_filt, True) == -(-n_filt // 16) * 16
        assert dft_plan.home_bytes(n_filt, False) == 0
    assert dft_plan.staging_bytes(True) == (
        8 * dft_plan.STAGE_CAP * 12 if dft_plan.LOGMEL_FINISH == 3 else 0)
    assert dft_plan.staging_bytes(False) == 0
    # the shipped design stores the raw sums and logs them in one pass
    # after the walk
    assert ("if constexpr (kCut == 6 || kFinish == 0) {\n    return x;"
            in _body("__device__ __forceinline__ float finish_log("))
    assert "log_pass(dst, rows * width, tid);" in SRC


@pytest.mark.parametrize("n_fft", [1024, 512, 400])
def test_each_bin_is_walked_by_one_quad_lane(n_fft):
    """walk_lanes is chunk_bin's lane: in the full chunks lane t walks the
    run 16 t n_full .. 16 (t + 1) n_full - 1; in a last chunk of 16 columns
    bin n_full BN / 2 + 4 j + t; every bin once."""
    p = ListenerParams(n_fft=n_fft, window_t=min(n_fft, 400) / 16000)
    rows = dft_layout(p).wgmma_rows
    lane = dft_plan.walk_lanes(rows)
    assert len(lane) == rows // 2 and set(lane) == set(range(dft_plan.QUAD))
    n_full = rows // dft_plan.BN
    for t in range(dft_plan.QUAD):
        run = np.flatnonzero(lane == t)
        np.testing.assert_array_equal(
            run[run < n_full * 64], np.arange(16 * t * n_full,
                                              16 * (t + 1) * n_full))
        if rows % dft_plan.BN == 16:
            np.testing.assert_array_equal(run[run >= n_full * 64],
                                          n_full * 64 + t + np.array([0, 4]))


@pytest.mark.parametrize("feature_type", ["mfcc", "bark"])
def test_every_filter_has_one_home(feature_type):
    """At n_fft 1024 and 20-512 filters: a filter whose nonzero weights all
    lie in one lane's walk is that lane's; one weighed by several walks is
    a boundary filter (at most 4 S of them: the runs' three seams and the
    last chunk's bins); one no bin weighs is HOME_NONE.  The tail lists the
    boundary filters in code order, then the weightless ones."""
    for n_filt in MANY_FILTERS:
        p = ListenerParams(n_filt=n_filt)
        filt_t = filterbank_matrix(p, feature_type).T
        rows = dft_layout(p, feature_type).wgmma_rows
        slots = dft_plan.filter_slots(filt_t, rows // 2)
        homes = dft_plan.filter_homes(slots, n_filt, rows)
        lane = dft_plan.walk_lanes(rows)[:p.n_fft_bins]
        bnd = []
        for f in range(n_filt):
            walks = set(lane[np.flatnonzero(filt_t[f])])
            code = int(homes.home[f])
            if len(walks) == 1:
                assert code == walks.pop(), (n_filt, f)
            elif walks:
                assert code == dft_plan.HOME_SHARED + len(bnd), (n_filt, f)
                bnd.append(f)
            else:
                assert code == dft_plan.HOME_NONE, (n_filt, f)
        assert homes.n_bnd == len(bnd) <= 4 * slots.slots
        zero = [f for f in range(n_filt) if not filt_t[f].any()]
        assert homes.tail.tolist() == bnd + zero


@pytest.mark.parametrize("feature_type", ["mfcc", "bark"])
def test_logmel_block_keeps_four_windows(feature_type):
    """dft_layout(logmel=True) at n_fft 1024 holds 4 windows (120 of 128
    rows) at every n_filt 20-512, a ring of 5 stages and the filter slots
    in shared memory, its bytes the source's sum (the n_bnd boundary sums
    a row and the home table in place of every filter sum); the first
    design's layout (`shared_sums`) keeps its own sum and fits too."""
    for n_filt in MANY_FILTERS:
        p = ListenerParams(n_filt=n_filt)
        lay = dft_layout(p, feature_type, logmel=True)
        slots = dft_plan.filter_slots(filterbank_matrix(p, feature_type).T,
                                      lay.wgmma_rows // 2).slots
        table = dft_plan.wgmma_table_bytes(lay.wgmma_rows, slots)
        assert (lay.wpb, lay.stages, lay.table_smem) == (4, 5, True), n_filt
        assert lay.logmel and not lay.shared_sums
        assert lay.smem_bytes == dft_plan.wgmma_smem_bytes(
            4, lay.win_pitch, n_filt, p.n_mfcc, lay.k_pad, table, 5,
            n_features=p.n_features, logmel=True,
            n_bnd=lay.n_bnd) <= DFT_SMEM_MAX
        old = dft_layout(p, feature_type, logmel=True, shared_sums=True)
        assert old.shared_sums and old.n_bnd == 0
        old_table = dft_plan.wgmma_table_bytes(old.wgmma_rows, slots) \
            if old.table_smem else 0
        assert old.smem_bytes == dft_plan.wgmma_smem_bytes(
            old.wpb, old.win_pitch, n_filt, p.n_mfcc, old.k_pad, old_table,
            old.stages, n_features=p.n_features, logmel=True,
            shared_sums=True) <= DFT_SMEM_MAX
        assert old.wpb <= lay.wpb
        assert dft_config_error(p, feature_type, layout=lay) is None


def test_mode_rule_is_pinned():
    """The wgmma kernel's mode at n_fft 1024: log-mel mode with the cepstrum
    kernel where the fused block holds fewer windows than the log-mel
    block's 4 (80 x 11: 3 windows, 800 products) or from
    DFT_CEP_MIN_PRODUCTS DCT products a frame (the sweep's 48 x 20); the
    default config, and 32 x 20, 40 x 13, 40 x 20 and 64 x 13 fused."""
    assert DFT_CEP_MIN_PRODUCTS == 912
    for n_filt, n_mfcc, cep in ((20, 20, False), (32, 20, False),
                                (40, 13, False), (40, 20, False),
                                (64, 13, False), (48, 20, True),
                                (64, 20, True), (80, 20, True),
                                (96, 20, True), (240, 20, True),
                                (512, 20, True), (80, 11, True)):
        p = ListenerParams(n_filt=n_filt, n_mfcc=n_mfcc)
        assert dft_cepstrum(p) == cep, (n_filt, n_mfcc)
        assert DftConstants(p, "mfcc", "cpu").layout == dft_layout(
            p, logmel=cep)


def _block_acc(p, feature_type, audio, consts):
    """One block's accumulators (BM, wgmma_rows) in the wgmma column order:
    the bf16 frames times the kernel's bf16 matrix, exact in float64 and
    rounded to f32 (the products' summation order aside)."""
    lay = consts.layouts[True]
    x = decode(audio)
    frames = frame_signal(x.to(torch.bfloat16).float(), p.window_samples,
                          p.hop_samples)[..., -p.n_features:, :]
    frames = frames.reshape(-1, p.window_samples)
    a = torch.zeros(dft_plan.BM, lay.k_pad, dtype=torch.float64)
    a[:len(frames), :lay.k_eff] = frames[:, :lay.k_eff].double()
    return (a @ consts.dft_wgmma.double().T).float().numpy(), len(frames)


def decode(audio):
    if audio.dtype == torch.int16:
        return audio.float() * (GAIN / 32768.0)
    return audio * GAIN


def _emulated_rows(p, feature_type, audio):
    consts = DftConstants(p, feature_type, "cpu")
    acc, rows = _block_acc(p, feature_type, audio, consts)
    lay = consts.layouts[True]
    slots = dft_plan.filter_slots(filterbank_matrix(p, feature_type).T,
                                  lay.wgmma_rows // 2)
    homes = dft_plan.filter_homes(slots, p.n_filt, lay.wgmma_rows)
    np.testing.assert_array_equal(consts.filt_home.numpy(), homes.home)
    np.testing.assert_array_equal(consts.tail_filt.numpy(), homes.tail)
    out, writes = dft_plan.emulate_logmel(acc, p.n_filt, slots, homes,
                                          1.0 / p.n_fft, rows)
    assert (writes[:rows] == 1).all() and not writes[rows:].any()
    return torch.tensor(out[:rows]).reshape(len(audio), p.n_features,
                                            p.n_filt + 1)


# (feature_type, n_filt, windows, int16): a full block of 4 windows, and
# a block's last 3 (its padding rows write nothing)
EMULATED = {"mel 240 x 4": ("mfcc", 240, 4, False),
            "mel 512 x 3 int16": ("mfcc", 512, 3, True),
            "bark 160 x 4": ("bark", 160, 4, False)}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_emulated_rows_are_the_plain_rows(name):
    """Every cell of the block's rows written once; the emulated rows and
    the plain fast_math rows each within the feature bound plus slack of
    the float64 rows."""
    feature_type, n_filt, windows, int16 = EMULATED[name]
    p = ListenerParams(n_filt=n_filt)
    audio = ca.speech_audio(windows, p.max_samples, 3, "cpu")
    if int16:
        audio = torch.round(audio * 32768).clamp(-32768, 32767).to(torch.int16)
    got = _emulated_rows(p, feature_type, audio)
    plain = cepstrum_plan.logmel_plain(
        Frontend(p, feature_type, "cpu", fast_math=True), audio, GAIN)
    exact = ca.exact_logmel(p, audio, GAIN, feature_type, fast_math=True)
    ca.check_conditioned(name, got, plain, *exact)


def test_emulated_rows_through_the_dct_are_jax_fast_math():
    """The emulated rows at 240 filters, through the plain DCT and energy
    swap (`cepstrum_plan.cepstrum_plain`), and JAX's fused fast_math
    frontend (dense DFT, interpret mode) on the same two windows: each
    within the feature bound plus slack of the float64 features."""
    kw = dict(n_filt=240, n_mfcc=20)
    p = ListenerParams(**kw)
    audio = ca.speech_audio(2, p.max_samples, 4, "cpu")
    rows = _emulated_rows(p, "mfcc", audio)
    got = cepstrum_plan.cepstrum_plain(
        rows, torch.tensor(dct_t_matrix(p.n_filt)), p.n_mfcc)
    fused = make_fused_frontend(JaxParams(**kw), batch_tile=2,
                                interpret=True, fast_math=True,
                                dft_mode="dense")
    want = torch.tensor(np.asarray(fused(jnp.asarray(audio.numpy()), GAIN)))
    exact = ca.exact_features(p, audio, GAIN, fast_math=True)
    ca.check_conditioned("emulated log-mel mode + DCT vs JAX fast_math", got,
                         want, *exact)
