"""The plan `csrc/mfcc_frontend.cu`'s register-resident real-input FFT
follows (`ops/fft_plan.py`), on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py holds it to the
plain frontend there).  Here a numpy emulation of the same passes, on the
same tables the kernel reads, is held to:
- np.fft.rfft in float64, at every size the register body takes: atol 1e-4
  times the frame's max |X| in float32 (f32 rounding over three passes and
  the untangle), 1e-9 in float64 (the same arithmetic, exact tables);
- the plain `Frontend` (power -> packed mel -> log -> DCT, energy, deltas):
  the f32 feature bound FEAT_ATOL / FEAT_RTOL the kernel is held to on the
  card (another summation order, magnified by the log);
- `truncated_plain` for the stage cuts' lane maps (framing, power, mel,
  log, full): `dev.r3_omission.TOLERANCES`.
And the plan's own properties: row-major float64-built tables, every
exchange at the least shared-memory wavefronts, the shared memory and the
warps an SM at n_fft 1024, the body each n_fft takes.
"""
import numpy as np
import pytest
import torch

from tpu_speech_commands_torch.dev import FEAT_ATOL, FEAT_RTOL
from tpu_speech_commands_torch.dev.r3_omission import TOLERANCES
from tpu_speech_commands_torch.frontend import Frontend
from tpu_speech_commands_torch.frontend.filterbanks import (LOG_EPS,
                                                            dct_t_matrix,
                                                            filterbank_matrix)
from tpu_speech_commands_torch.ops import fft_plan as fp
from tpu_speech_commands_torch.ops.frontend_kernel import (KernelConstants,
                                                           MfccFrontend,
                                                           fft_body,
                                                           frontend_route)
from tpu_speech_commands_torch.ops.omission_kernel import truncated_plain
from tpu_speech_commands_torch.params import ListenerParams

SIZES = [128, 256, 512, 1024, 2048, 4096]


def _tw(consts: KernelConstants, dtype=np.complex64):
    t = consts.plan_twiddle.numpy().astype(np.float64)
    return (t[:, 0] + 1j * t[:, 1]).astype(dtype)


def _frames(audio, gain, p: ListenerParams):
    """The kernel's frames: x = pcm * (gain / 32768) or audio * gain, the
    last n_features frames, each cut or zero-padded to n_fft."""
    if audio.dtype == np.int16:
        x = audio.astype(np.float32) * np.float32(gain * (1.0 / 32768.0))
    else:
        x = audio * np.float32(gain)
    w = min(p.window_samples, p.n_fft)
    n_frames = 1 + (x.shape[-1] - p.window_samples) // p.hop_samples
    out = np.zeros(x.shape[:-1] + (p.n_features, p.n_fft), np.float32)
    for f in range(p.n_features):
        t = n_frames - p.n_features + f
        out[..., f, :w] = x[..., t * p.hop_samples: t * p.hop_samples + w]
    return out


def emulate_frontend(audio, gain, p: ListenerParams, feature_type: str,
                     stop: str = "full"):
    """The register body in float32 numpy: (B, S) -> (B, T, F) features, or
    with stop="mel" / "log" the per-frame 128-lane rows of those cuts."""
    consts = KernelConstants(p, feature_type, "cpu")
    fb = consts.fb
    frames = _frames(audio, gain, p)
    b, t = frames.shape[:2]
    x = fp.emulate_rfft(frames.reshape(b * t, -1), consts.plan, _tw(consts))
    power = ((x.real ** 2 + x.imag ** 2) / np.float32(p.n_fft)).astype(np.float32)
    energy = power.sum(-1)
    partial = np.stack([
        (power[:, k0:k0 + cnt] * fb.packed[o0:o0 + cnt]).sum(-1)
        for k0, o0, cnt in fb.segments], -1)
    mel = np.stack([partial[:, fb.filt_seg[m]:fb.filt_seg[m + 1]].sum(-1)
                    for m in range(p.n_filt)], -1).astype(np.float32)
    if stop in ("mel", "log"):
        row = np.zeros((b * t, 128), np.float32)
        row[:, :p.n_filt], row[:, p.n_filt] = mel, energy
        row = np.log(np.maximum(row, LOG_EPS)) if stop == "log" else row
        return row.reshape(b, t, 128)
    logs = np.log(np.maximum(mel, LOG_EPS)).astype(np.float32)
    feats = logs @ dct_t_matrix(p.n_filt)[:, :p.n_mfcc]
    feats[:, 0] = np.log(np.maximum(energy, LOG_EPS))
    feats = feats.reshape(b, t, p.n_mfcc)
    if p.use_delta:
        deltas = np.concatenate([np.zeros_like(feats[:, :1]),
                                 np.diff(feats, axis=1)], 1)
        feats = np.concatenate([feats, deltas], -1)
    return feats


@pytest.fixture(scope="module")
def audio():
    """(4, 16000) speech-like float32: tones plus noise at several levels."""
    rng = np.random.default_rng(8)
    t = np.arange(16000) / 16000.0
    rows = [a * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(16000)
            for a, f in ((0.5, 440), (0.1, 1300), (0.8, 2900), (0.02, 6100))]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("n_fft", SIZES)
def test_plan_tables_row_major_float64_built(n_fft):
    """The constants the register body reads: row-major, float32 copies of
    float64-built values (checked against an independent construction)."""
    p = ListenerParams(n_fft=n_fft)
    c = KernelConstants(p, "mfcc", "cpu")
    plan = c.plan
    for t, dtype in ((c.plan_twiddle, torch.float32),
                     (c.filt_packed, torch.float32), (c.fb_table, torch.int32)):
        assert t.is_contiguous() and t.dtype == dtype
    want = []
    for radix, ns in zip(plan.radices[1:], plan.strides[1:]):
        r, col = np.meshgrid(np.arange(1, radix), np.arange(ns), indexing="ij")
        want.append(np.exp(-2j * np.pi * r * col / (ns * radix)).ravel())
    want.append(np.exp(-1j * np.pi * np.arange(plan.n // 2 + 1) / plan.n))
    want = np.concatenate(want)
    got = c.plan_twiddle.numpy()
    np.testing.assert_allclose(got[:, 0], want.real, atol=6e-8, rtol=0)
    np.testing.assert_allclose(got[:, 1], want.imag, atol=6e-8, rtol=0)
    assert plan.n * 2 == n_fft and plan.lanes * plan.values == plan.n
    assert np.prod(plan.radices) == plan.n and len(plan.radices) <= 3
    fb = fp.filterbank_plan(filterbank_matrix(p, "mfcc").T, plan.lanes)
    np.testing.assert_array_equal(c.fb_table.numpy(), fb.table)
    np.testing.assert_array_equal(c.filt_packed.numpy(), fb.packed)


@pytest.mark.parametrize("n_fft", SIZES)
def test_emulated_passes_equal_rfft(n_fft):
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((6, n_fft)).astype(np.float32)
    frames[1] *= 1e-3
    frames[2, n_fft // 3:] = 0.0  # a zero-padded window
    want = np.fft.rfft(frames.astype(np.float64), axis=-1)
    c = KernelConstants(ListenerParams(n_fft=n_fft), "mfcc", "cpu")
    got32 = fp.emulate_rfft(frames, c.plan, _tw(c))
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got32 - want) <= 1e-4 * scale).all()
    plan64 = fp.fft_plan(n_fft)
    tw64 = plan64.twiddle[:, 0] + 1j * plan64.twiddle[:, 1]
    got64 = fp.emulate_rfft(frames.astype(np.float64), plan64, tw64)
    np.testing.assert_allclose(got64, want, atol=1e-9 * scale.max(), rtol=0)


FEATURE_CASES = {
    "default": ({}, "mfcc", "float32", 0.8),
    "bark int16": ({}, "bark", "int16", 1.25),
    "use_delta": ({"use_delta": True}, "mfcc", "float32", 1.0),
    "window < n_fft": ({"window_t": 0.05}, "mfcc", "int16", 1.0),
    "window 1200 > n_fft": ({"window_t": 0.075}, "mfcc", "float32", 0.9),
    "odd hop 481": ({"hop_t": 481 / 16000}, "mfcc", "float32", 1.1),
    "alt_512": ({"window_t": 0.025, "hop_t": 0.01, "n_fft": 512,
                 "n_filt": 26, "n_mfcc": 13}, "mfcc", "float32", 0.8),
    "n_fft=128": ({"n_fft": 128, "window_t": 0.008}, "mfcc", "float32", 0.8),
    "n_fft=256": ({"n_fft": 256, "window_t": 0.016}, "bark", "float32", 0.8),
    "n_fft=2048": ({"n_fft": 2048}, "mfcc", "int16", 0.8),
    "n_fft=4096": ({"n_fft": 4096}, "mfcc", "float32", 0.8),
}


@pytest.mark.parametrize("name", sorted(FEATURE_CASES))
def test_emulated_features_match_plain_frontend(audio, name):
    kw, feature_type, dtype, gain = FEATURE_CASES[name]
    p = ListenerParams(**kw)
    x = audio if dtype == "float32" else \
        np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    want = Frontend(p, feature_type, "cpu")(torch.tensor(x), gain).numpy()
    got = emulate_frontend(x, gain, p, feature_type)
    assert got.shape == want.shape == (4, p.n_features, p.feature_size)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=FEAT_RTOL)


@pytest.mark.parametrize("stage", ["framing", "power", "mel", "log", "full"])
def test_cut_lane_maps_match_truncated_plain(audio, stage):
    """The register body's stage cuts at n_fft 1024 (L = 32 lanes a frame):
    framing from the pass-0 registers, lane l's slots at output lanes 2l,
    2l + 1, 2l + 64, 2l + 65; power from the power row read 8 bins at a
    time plus the signed Nyquist amplitude; mel and log as 128-lane rows;
    full, the coefficients.  Each folded over the frames."""
    p = ListenerParams()
    x = np.tile(audio, (4, 1))  # 16 windows, the cuts' batch tile
    gain = 1.3
    plan = fp.fft_plan(p.n_fft)
    frames = _frames(x, gain, p)  # window = n_fft: frames 0 .. 29
    b, t, lanes = frames.shape[0], frames.shape[1], plan.lanes
    if stage == "framing":
        z = frames[..., 0::2] + 1j * frames[..., 1::2]  # z[l + 32 r]
        row = np.zeros((b, t, 128), np.float32)
        for lane in range(lanes):
            for r in range(16):
                v = z[..., lane + lanes * r]
                row[..., 2 * lane + 64 * (r & 1)] += v.real
                row[..., 2 * lane + 1 + 64 * (r & 1)] += v.imag
    elif stage == "power":
        c = KernelConstants(p, "mfcc", "cpu")
        xb = fp.emulate_rfft(frames.reshape(b * t, -1), plan, _tw(c))
        power = (np.abs(xb) ** 2 / p.n_fft).astype(np.float32)
        xnyq = xb[:, plan.n].real / np.sqrt(np.float32(p.n_fft))
        row = np.zeros((b * t, 128), np.float32)
        for lane in range(32):
            for k in range(2):
                j = lane + 32 * k
                bins = power[:, 8 * j: 8 * j + 8]
                row[:, j] = xnyq + bins[:, 0::2].sum(-1)
                row[:, 64 + j] = xnyq + bins[:, 1::2].sum(-1)
        row = row.reshape(b, t, 128)
    elif stage in ("mel", "log"):
        row = emulate_frontend(x, gain, p, "mfcc", stop=stage)
    else:
        feats = emulate_frontend(x, gain, p, "mfcc")
        row = np.pad(feats, ((0, 0), (0, 0), (0, 128 - p.n_mfcc)))
    got = row.sum(1)
    want = truncated_plain(torch.tensor(x), gain, p, stage).numpy()
    atol, rtol = TOLERANCES[stage]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _wavefronts(slots):
    """Shared-memory wavefronts of one warp-wide float2 access: a
    half-warp at a time, the most distinct float2 slots that fall in one
    of the 16 bank pairs."""
    total = 0
    for half in (slots[:16], slots[16:]):
        banks = {}
        for s in set(half):
            banks.setdefault(s % 16, set()).add(s)
        total += max(len(v) for v in banks.values())
    return total


@pytest.mark.parametrize("n_fft", SIZES)
def test_every_exchange_takes_the_least_wavefronts(n_fft):
    """Two wavefronts (the least for 32 float2) for every pass's writes and
    the next pass's reads (swizzled before the last pass, linear after it)
    and the untangle's reads of Z[k] and Z[N - k], with the frames that
    share a warp `pitch` float2 apart."""
    plan = fp.fft_plan(n_fft)
    lanes, n = plan.lanes, plan.n
    last = len(plan.radices) - 1

    def slot(lane, index, swizzled):
        frame = lane // lanes
        return frame * plan.pitch + int(fp.swizzle(index) if swizzled else index)

    def access(index_of_lane, swizzled):
        return _wavefronts([slot(lane, index_of_lane(lane % lanes), swizzled)
                            for lane in range(32)])

    counts = []
    for p in range(len(plan.radices)):
        reads, writes, _ = fp.pass_maps(plan, p)
        for b in range(reads.shape[1]):
            for r in range(reads.shape[2]):
                if p > 0:
                    counts.append(access(lambda l: reads[l, b, r], True))
                counts.append(access(lambda l: writes[l, b, r], p < last))
    for i in range(plan.values // 2):
        counts.append(access(lambda l: l + lanes * i, False))
        counts.append(access(lambda l: (n - l - lanes * i) % n, False))
    assert set(counts) == {2}


def test_layout_fits_and_holds_32_warps_at_n_fft_1024():
    p = ListenerParams()
    lay = KernelConstants(p, "mfcc", "cpu").layout
    assert lay.smem_bytes <= fp.SMEM_OPTIN
    assert lay.warps_per_sm >= 32 and lay.blocks_per_sm == 4
    assert lay.frames == 8 * 512 * 8  # 4 KB a frame slot, 8 slots
    assert lay.smem_bytes == sum((lay.twiddle, lay.weights, lay.table, lay.dct,
                                  lay.frames, lay.scratch, lay.feats))
    for name in FEATURE_CASES:
        kw, feature_type, _, _ = FEATURE_CASES[name]
        q = ListenerParams(**kw)
        assert KernelConstants(q, feature_type, "cpu").layout.smem_bytes <= \
            fp.SMEM_OPTIN


@pytest.mark.parametrize("n_fft", [2 ** e for e in range(1, 15)])
def test_body_each_n_fft_takes(n_fft):
    """n_fft 128 .. 4096 takes the register body, every other power of two
    the radix-2 body; both are route "fft", on the FFT kernel."""
    p = ListenerParams(n_fft=n_fft, window_t=min(0.064, n_fft / 16000))
    body = fft_body(p)
    assert body == ("register" if 128 <= n_fft <= 4096 else "radix2")
    assert frontend_route(p) == "fft"
    assert MfccFrontend(p, "mfcc", "cpu").route == "fft"
    if n_fft <= 8192:  # the constants' dense filterbank is (n_filt, n_fft/2+1)
        c = KernelConstants(p, "mfcc", "cpu")
        assert (c.plan is None) == (body == "radix2")


@pytest.mark.parametrize("kw,body", [
    ({"n_filt": 200}, "register"),
    ({"n_filt": 240}, "radix2"),  # its 230 KB DCT leaves no room
    ({"n_fft": 4096, "n_filt": 200}, "register"),  # on one warp a block
])
def test_body_follows_the_register_layout(kw, body):
    """A config whose register-body shared memory exceeds a block's, even
    at one warp, takes the radix-2 body: the choice is the config's, so
    nothing the radix-2 body serves is refused."""
    p = ListenerParams(**kw)
    assert fft_body(p) == body
    c = KernelConstants(p, "mfcc", "cpu")
    assert (c.plan is None) == (body == "radix2")
    if c.layout is not None:
        assert c.layout.smem_bytes <= fp.SMEM_OPTIN


@pytest.mark.parametrize("case", ["mfcc", "bark", "alt_512", "n_fft=128",
                                  "n_fft=4096"])
def test_filterbank_plan_covers_each_weight_once(case):
    """Every packed weight lies in exactly one segment, each segment inside
    one filter's range, a lane's segments one run of at most `chunk` (odd)
    weights, back to back, and filter m's segments a contiguous block: the
    partial sums add up to the dense filterbank product."""
    kw, feature_type = {
        "mfcc": ({}, "mfcc"), "bark": ({}, "bark"),
        "alt_512": ({"n_fft": 512, "n_filt": 26, "n_mfcc": 13}, "mfcc"),
        "n_fft=128": ({"n_fft": 128, "window_t": 0.008}, "mfcc"),
        "n_fft=4096": ({"n_fft": 4096}, "mfcc")}[case]
    p = ListenerParams(**kw)
    filt_t = filterbank_matrix(p, feature_type).T
    lanes = fp.fft_plan(p.n_fft).lanes
    fb = fp.filterbank_plan(filt_t, lanes)
    assert fb.chunk % 2 == 1 and fb.chunk * lanes >= len(fb.packed)
    seen = np.zeros(len(fb.packed), int)
    for lane in range(lanes):
        segs = fb.segments[fb.lane_seg[lane]:fb.lane_seg[lane + 1]]
        assert segs[:, 2].sum() <= fb.chunk
        if len(segs):  # one run: each segment's weights follow the last's
            assert segs[0, 1] == lane * fb.chunk
            assert (segs[1:, 1] == segs[:-1, 1] + segs[:-1, 2]).all()
        for k0, o0, cnt in segs:
            seen[o0:o0 + cnt] += 1
    assert (seen == 1).all()
    power = np.random.default_rng(3).random(p.n_fft_bins)
    for m, (lo, hi, off) in enumerate(fb.ranges):
        total = 0.0
        for k0, o0, cnt in fb.segments[fb.filt_seg[m]:fb.filt_seg[m + 1]]:
            assert lo <= k0 and k0 + cnt <= hi and o0 - off == k0 - lo
            total += power[k0:k0 + cnt] @ fb.packed[o0:o0 + cnt]
        np.testing.assert_allclose(total, power @ filt_t[m], rtol=1e-6)


def test_ablation_variants_each_match_the_kernel_source_once():
    """dev/fft_ablation.py edits csrc/mfcc_frontend.cu (its header inlined)
    by text: each
    variant's text is in the source once, and each variant differs."""
    from tpu_speech_commands_torch.dev import fft_ablation

    sources = fft_ablation.variant_sources()
    assert set(sources) == {"base", *fft_ablation.VARIANTS}
    assert len(set(sources.values())) == len(sources)


@pytest.mark.parametrize("n_fft", SIZES)
def test_source_plan_alias_is_the_python_plan(n_fft):
    """csrc/mfcc_frontend.cu's `Plan<N>` (values a lane, launch-bounds
    blocks, the radices of its RegisterPlan), evaluated from the source's
    text at N = n_fft / 2, is `fft_plan(n_fft)`."""
    import re

    from tpu_speech_commands_torch.ops import _build

    src = (_build.CSRC_DIR / "mfcc_frontend.cu").read_text()
    m = re.search(r"template <int N, int V = \((.*?)\),\s*int B = \((.*?)\)>\s*"
                  r"using Plan = std::conditional_t<\((.*?)\), "
                  r"RegisterPlan<N, V, B, ([^>]*)>,\s*RegisterPlan<N, V, B, "
                  r"([^>]*)>>;", src, re.S)
    assert m, "Plan<N> moved in csrc/mfcc_frontend.cu"

    def ternary(expr):  # a ? b : c ? d : e, right to left
        if " ? " not in expr:
            return expr
        cond, rest = expr.split(" ? ", 1)
        then, other = rest.split(" : ", 1)
        return f"({then}) if ({cond}) else ({ternary(other)})"

    def c_eval(expr, **names):
        return eval(ternary(expr.replace("/", "//")), {}, names)

    n = n_fft // 2
    v = c_eval(m.group(1), N=n)
    b = c_eval(m.group(2).replace("(", "").replace(")", ""), V=v)
    radices = m.group(4) if c_eval(m.group(3), N=n) else m.group(5)
    radices = tuple(c_eval(r.strip(), N=n) for r in radices.split(","))
    plan = fp.fft_plan(n_fft)
    assert (v, b, radices) == (plan.values, plan.min_blocks, plan.radices)
