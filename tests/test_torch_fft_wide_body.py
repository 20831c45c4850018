"""The FFT kernel's wide body at n_fft 8192 and 16384
(`csrc/mfcc_wide_frontend.cu`, plan `ops/fft_plan.py::fft_wide_plan`: the
register body with a frame over two or four warps), on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py holds it to the
plain chain there).  Here:
- the CUDA unit's plan table equals `FFT_WIDE_PLANS`, each plan runs
  `wide_rule`'s passes (radix 16 at most) on 128 lanes (V = 32 at 8192,
  64 at 16384) and its block fits SMEM_OPTIN at 20 and 40 filters, mfcc
  and bark;
- a numpy emulation of the passes (`fft_plan.emulate_rfft`) on each plan,
  the shipped two and the other 8192 candidate (`wide_rule`'s V = 64 on 64
  lanes),
  against np.fft.rfft in float64: within 1e-5 of the frame's max |X| in
  float32 (f32 rounding over 3-4 passes and the untangle), 1e-9 in
  float64;
- the emulated features (tests/test_torch_fft_plan.py's `emulate_frontend`
  on the wide plan) against the port's plain chain (`frontend/dsp.py::
  Frontend`, what `MfccFrontend` runs on the CPU) at n_fft = window = 8192
  (mfcc, int16, deltas), 8192 at window 6000 (bark, zero-padded) and 16384
  at window 12800, two windows each, and at n_fft = window = 8192 against
  the JAX package's plain XLA frontend (`tpu_speech_commands/frontend/
  dsp.py::Frontend`), at RTOL / ATOL 1e-4 (tests/test_torch_wide_fft.py's
  bound for the same arithmetic against the same references);
- the body each config takes: "wide" at these sizes where the block fits,
  "radix2" where the DCT of 240 filters leaves it no room; a config whose
  radix-2 buffer exceeds shared memory (n_fft 32768) refused from the
  config.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fft_plan import emulate_frontend
from tpu_speech_commands.frontend.dsp import Frontend as JaxFrontend
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands_torch.frontend import Frontend
from tpu_speech_commands_torch.frontend.filterbanks import filterbank_matrix
from tpu_speech_commands_torch.ops import _build
from tpu_speech_commands_torch.ops import fft_plan as fp
from tpu_speech_commands_torch.ops.frontend_kernel import (
    KernelConstants, MfccFrontend, fft_body, frontend_route,
    kernel_config_error, radix2_smem_bytes)
from tpu_speech_commands_torch.params import ListenerParams

SIZES = sorted(fp.FFT_WIDE_PLANS)
RTOL, ATOL = 1e-4, 1e-4
SOURCE = (_build.CSRC_DIR / "mfcc_wide_frontend.cu").read_text()
# each plan the emulation runs: the shipped ones and the 8192 candidate of
# 64 values a lane on 64 lanes (dev/wide_ablation.py --route fft)
PLANS = {
    "8192": fp.fft_wide_plan(8192),
    "8192 V=64": fp.build_plan(8192, 64, *fp.FFT_WIDE_PLANS[8192][1:]),
    "16384": fp.fft_wide_plan(16384),
}


def test_source_plan_table_is_the_python_table():
    """csrc/mfcc_wide_frontend.cu's TSC_FFT_WIDE_PLANS rows (n_fft / 2,
    values, blocks, radices) are FFT_WIDE_PLANS' (the warps are the
    launch's argument), and its entry point runs them."""
    table = re.search(r"#define TSC_FFT_WIDE_PLANS\(X\)(.*?)\n\n", SOURCE,
                      re.S).group(1)
    got = {2 * int(n): (int(v), tuple(int(r) for r in rad.split(",")), int(b))
           for n, v, b, rad in re.findall(
               r"X\((\d+), (\d+), (\d+), ([\d, ]+)\)", table)}
    assert got == {n: plan[:3] for n, plan in fp.FFT_WIDE_PLANS.items()}
    assert "TSC_REGISTER_PLANS(tsc_mfcc_wide_frontend, TSC_FFT_WIDE_PLANS)" \
        in SOURCE
    assert "register_entry<tsc_mfcc_wide_frontend_plans>(" in SOURCE


@pytest.mark.parametrize("n_fft", SIZES)
def test_plan_is_the_wide_rule_and_fits(n_fft):
    plan = fp.fft_wide_plan(n_fft)
    values, radices, _, warps = fp.FFT_WIDE_PLANS[n_fft]
    assert radices == fp.wide_rule(n_fft)[1]
    assert plan.n == n_fft // 2 and plan.lanes * plan.values == plan.n
    assert plan.lanes == 128 and not plan.staged  # one frame a block
    assert plan.values == plan.lane_slots == n_fft // 256
    assert all(r <= 16 for r in radices) and int(np.prod(radices)) == plan.n
    assert warps == fp.WIDE_WARPS == plan.max_warps
    for p in range(len(radices)):
        reads = fp.pass_maps(plan, p)[0]
        assert reads[..., 0].size == plan.n // radices[p]  # no idle butterfly
    for n_filt in (20, 40):
        for feature_type in ("mfcc", "bark"):
            for window_t in (n_fft / 16000, 0.064):
                p = ListenerParams(n_fft=n_fft, n_filt=n_filt,
                                   window_t=min(window_t, 0.8))
                fb = fp.filterbank_plan(filterbank_matrix(p, feature_type).T,
                                        plan.lanes)
                lay = fp.fft_layout(plan, fb, n_filt, p.n_mfcc, p.n_features)
                assert lay.smem_bytes <= fp.SMEM_OPTIN
                assert lay.warps == fp.WIDE_WARPS and lay.blocks_per_sm >= 1
                assert lay.twiddle == lay.weights == 0  # read through the cache
                assert fft_body(p, feature_type) == "wide"


@pytest.mark.parametrize("name", sorted(PLANS))
def test_emulated_passes_equal_rfft(name):
    plan = PLANS[name]
    rng = np.random.default_rng(plan.n_fft + plan.values)
    frames = rng.standard_normal((4, plan.n_fft)).astype(np.float32)
    frames[1] *= 1e-3
    frames[2, 6000:] = 0.0  # a zero-padded window
    want = np.fft.rfft(frames.astype(np.float64), axis=-1)
    t = plan.twiddle.astype(np.float32).astype(np.float64)
    got32 = fp.emulate_rfft(frames, plan,
                            (t[:, 0] + 1j * t[:, 1]).astype(np.complex64))
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got32 - want) <= 1e-5 * scale).all()
    got64 = fp.emulate_rfft(frames.astype(np.float64), plan,
                            plan.twiddle[:, 0] + 1j * plan.twiddle[:, 1])
    np.testing.assert_allclose(got64, want, atol=1e-9 * scale.max(), rtol=0)


@pytest.fixture(scope="module")
def audio():
    """(2, 16000) speech-like float32: tones plus noise at two levels."""
    rng = np.random.default_rng(23)
    t = np.arange(16000) / 16000.0
    rows = [a * np.sin(2 * np.pi * f * t) + 0.03 * rng.standard_normal(16000)
            for a, f in ((0.6, 523), (0.05, 3100))]
    return np.stack(rows).astype(np.float32)


def _pcm(audio):
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)


FEATURE_CASES = {
    "8192 = window, mfcc int16 deltas": (
        {"n_fft": 8192, "window_t": 0.512, "use_delta": True}, "mfcc", "int16"),
    "8192, window 6000, bark": (
        {"n_fft": 8192, "window_t": 0.375}, "bark", "float32"),
    "16384, window 12800": ({"n_fft": 16384, "window_t": 0.8}, "mfcc",
                            "float32"),
}


@pytest.mark.parametrize("name", sorted(FEATURE_CASES))
def test_emulated_features_match_the_plain_chain(audio, name):
    kw, feature_type, dtype = FEATURE_CASES[name]
    p = ListenerParams(**kw)
    assert fft_body(p, feature_type) == "wide"
    assert frontend_route(p) == "fft"
    assert MfccFrontend(p, feature_type, "cpu").body == "wide"
    x = audio if dtype == "float32" else _pcm(audio)
    want = Frontend(p, feature_type, "cpu")(torch.tensor(x), 1.3).numpy()
    got = emulate_frontend(x, 1.3, p, feature_type)
    assert got.shape == want.shape == (2, p.n_features, p.feature_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("feature_type,dtype,delta", [
    ("mfcc", "int16", True), ("bark", "float32", False)])
def test_emulated_features_match_the_jax_frontend(audio, feature_type, dtype,
                                                  delta):
    """n_fft = window = 8192 (16 frames) through the JAX package's plain
    XLA frontend, which has no gain: gain 1."""
    kw = {"n_fft": 8192, "window_t": 0.512, "use_delta": delta}
    x = audio if dtype == "float32" else _pcm(audio)
    want = np.asarray(JaxFrontend(JaxParams(**kw), feature_type)(
        jnp.asarray(x)))
    p = ListenerParams(**kw)
    got = emulate_frontend(x, 1.0, p, feature_type)
    assert got.shape == want.shape == (2, 16, p.feature_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_fft", SIZES)
def test_radix2_body_keeps_a_config_the_wide_block_cannot_hold(n_fft):
    """240 filters: the whole 230 KB DCT fits no block of the wide body,
    which sent the config to the radix-2 body; the block keeps only the 19
    columns the output uses now, and the wide body takes it, chosen from
    the config, in log-mel mode with the cepstrum kernel after it (those
    columns would still cost it warps an SM); the radix-2 body serves it
    through `_radix2=True`."""
    p = ListenerParams(n_fft=n_fft, n_filt=240)
    assert fft_body(p) == "wide"
    c = KernelConstants(p, "mfcc", "cpu")
    assert c.body == "wide" and c.plan is not None and c.cepstrum
    assert c.layout_for(p, full_dct=True).smem_bytes > fp.SMEM_OPTIN \
        >= c.layout_for(p).smem_bytes
    assert MfccFrontend(p, "mfcc", "cpu").body == "wide"


def test_a_radix2_buffer_beyond_shared_memory_is_refused_from_the_config(
        monkeypatch):
    """n_fft 32768 and 65536: the radix-2 body's one-warp buffer alone is
    256 KB or more, so no body takes them: the route is the plain chain on
    the card ("torch", as the JAX scorer's XLA frontend), chosen from the
    config, and the frontend builds for CUDA as far as the device check;
    the FFT kernel itself still refuses them.  16384 at 240 filters (the
    wide body) gets as far as the device check on route fft."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n_fft in (32768, 65536):
        p = ListenerParams(n_fft=n_fft)
        assert fft_body(p) == "radix2" and radix2_smem_bytes(p) > fp.SMEM_OPTIN
        assert frontend_route(p) == "torch"
        assert "radix-2 body's one-warp block" in kernel_config_error(p)
        assert MfccFrontend(p, "mfcc", "cpu").path == "torch"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MfccFrontend(p, "mfcc", "cuda")
    q = ListenerParams(n_fft=16384, n_filt=240)
    assert fft_body(q) == "wide" and kernel_config_error(q) is None
    assert frontend_route(q) == "fft"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MfccFrontend(q, "mfcc", "cuda")


def test_ablation_variants_each_match_the_kernel_source():
    """dev/wide_ablation.py --route fft edits the unit's plan table by
    text: every variant sets the 8192 plan's values and every plan's
    blocks; its V = 32 constants are the candidate plan's."""
    from tpu_speech_commands_torch.dev import wide_ablation

    sources = wide_ablation.fft_variant_sources()
    assert set(sources) == {f"v{v}_b{b}" for v in wide_ablation.FFT_VALUES
                            for b in wide_ablation.FFT_BLOCKS}
    for name, src in sources.items():
        values, blocks = (int(x) for x in name[1:].split("_b"))
        rows = re.findall(r"X\((\d+), (\d+), (\d+),", src)
        assert rows == [("4096", str(values), str(blocks)),
                        ("8192", "64", str(blocks))]
    p = ListenerParams(n_fft=8192, window_t=0.512)
    c = wide_ablation.fft_constants(p, 64, "cpu")
    assert (c.plan.values, c.plan.lanes, c.layout.warps) == (64, 64, 4)
    assert len(c.fb.lane_seg) == 65 and c.fb_table.dtype == torch.int32
    assert wide_ablation.fft_constants(p, 32, "cpu").plan is \
        fp.fft_wide_plan(8192)
