"""Route ct's wide register FFT above n_fft 4096 (`csrc/wide_fft.cuh`,
`csrc/wide_fft_frontend_*.cu`, plan `ops/fft_plan.py::wide_plan`), on the
CPU.

The kernel runs only on the card (tests/test_torch_gpu.py holds it to the
plain version there).  Here:
- the plans' invariants at all 45 sizes (n_fft = 256 m, m in 17 .. 62 but
  32): `wide_rule`, V <= 64 and a multiple of every odd radix, the
  power-of-two radices at most 16 in the fewest passes, L = 64 or 128
  lanes (two or four warps a frame), the block fits SMEM_OPTIN at 20 and
  40 filters;
- the CUDA sources' plan tables, unit by unit, equal the Python one;
- the odd primes 17 .. 61's cos and sin constants in the source against
  float64 cos and sin;
- a numpy emulation of the passes (`fft_plan.emulate_rfft`: a lane's last
  butterfly only where it exists), with the odd-radix DFT on the source's
  own constants, against np.fft.rfft at every size: atol 1e-4 times the
  frame's max |X| in float32, 1e-9 in float64;
- the emulated features against the JAX package's CT kernel
  (`make_fused_frontend(dft_mode="ct")`, interpret mode) and against
  `ct_frontend_plain` at n_fft 4352 (mfcc and bark, int16, with deltas),
  10240 and 15872, two windows each, at RTOL / ATOL 1e-4
  (tests/test_torch_ct_frontend.py's bound).
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.ops import make_fused_frontend
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands_torch.frontend.filterbanks import (LOG_EPS,
                                                            dct_t_matrix,
                                                            filterbank_matrix)
from tpu_speech_commands_torch.ops import _build, ct_kernel
from tpu_speech_commands_torch.ops import fft_plan as fp
from tpu_speech_commands_torch.params import ListenerParams

SIZES = sorted(fp.WIDE_PLANS)
RTOL, ATOL = 1e-4, 1e-4
HEADER = (_build.CSRC_DIR / "register_fft.cuh").read_text()


def _floats(text: str) -> np.ndarray:
    return np.array([float(x.strip().rstrip("f")) for x in text.split(",")],
                    np.float32)


def _source_cos_sin():
    """R -> (cos, sin) float32 tables of the source's cos_sin<R>, k < R: the
    full tables of 3 .. 13, and 17 .. 61's half tables (k <= R / 2) with
    the rest by symmetry, as cos_sin<R> reads them."""
    tables = {}
    for r, c, s in re.findall(
            r"R == (\d+)\) \{\s*constexpr float c\[\d+\] = \{([^}]*)\};\s*"
            r"constexpr float s\[\d+\] = \{([^}]*)\};", HEADER):
        tables[int(r)] = _floats(c), _floats(s)
    c, s = re.search(r"\} else \{\s*constexpr float c\[13\] = \{([^}]*)\};\s*"
                     r"constexpr float s\[13\] = \{([^}]*)\};", HEADER).groups()
    tables[13] = _floats(c), _floats(s)
    for r, c, s in re.findall(
            r"struct HalfCosSin<(\d+)> \{.*?constexpr float c\[\d+\] = "
            r"\{([^}]*)\};\s*constexpr float s\[\d+\] = \{([^}]*)\};",
            HEADER, re.S):
        r, c, s = int(r), _floats(c), _floats(s)
        k = np.arange(r)
        half = np.minimum(k, r - k)
        tables[r] = c[half], np.where(k <= r // 2, s[half], -s[half])
    return tables


COS_SIN = _source_cos_sin()
PRIMES = sorted({r for n in SIZES for r in fp.WIDE_PLANS[n][1] if r % 2})


def odd_dft(v: np.ndarray, dtype) -> np.ndarray:
    """OddDft<R>::run over the last axis: the pairs p_r = x_r + x_{R-r},
    q_r = x_r - x_{R-r}, a = x_0 + sum cos p_r, b = sum sin q_r, y_k = a -
    i b, y_{R-k} = a + i b, on the source's tables (float32), or exact
    ones (float64)."""
    r_ = v.shape[-1]
    if dtype == np.float64:
        ang = 2 * np.pi * np.arange(r_) / r_
        c, s = np.cos(ang), np.sin(ang)
    else:
        c, s = COS_SIN[r_]
    h = r_ // 2
    p = np.stack([v[..., r] + v[..., r_ - r] for r in range(1, h + 1)], -1)
    q = np.stack([v[..., r] - v[..., r_ - r] for r in range(1, h + 1)], -1)
    y = np.empty_like(v)
    y[..., 0] = v[..., 0] + p.sum(-1)
    for k in range(1, h + 1):
        idx = [(r * k) % r_ for r in range(1, h + 1)]
        a = v[..., 0] + (p * c[idx]).sum(-1)
        b = (q * s[idx]).sum(-1)
        y[..., k] = a - 1j * b
        y[..., r_ - k] = a + 1j * b
    return y


def kernel_dft(dtype):
    """The kernel's in-register DFT: np.fft.fft for a power of two (the
    register body's radix-2 DFT, held to it in test_torch_fft_plan.py),
    `odd_dft` for an odd prime."""
    def dft(v):
        if v.shape[-1] % 2:
            return odd_dft(v, dtype)
        return np.fft.fft(v, axis=-1)
    return dft


def _tw(plan, dtype):
    t = plan.twiddle.astype(np.float32).astype(np.float64)
    return (t[:, 0] + 1j * t[:, 1]).astype(dtype)


@pytest.mark.parametrize("n_fft", SIZES)
def test_plan_invariants(n_fft):
    plan = fp.wide_plan(n_fft)
    n, m = n_fft // 2, n_fft // 256
    values, radices, _, warps = fp.WIDE_PLANS[n_fft]
    assert (values, radices) == fp.wide_rule(n_fft)
    assert 17 <= m <= 62 and m != 32 and plan.n == n
    assert plan.lanes * plan.values == n and plan.lanes == (64 if m < 32
                                                            else 128)
    assert plan.warps_per_frame == plan.lanes // 32 and not plan.staged
    assert plan.values <= 64 and plan.lane_slots <= 64
    assert int(np.prod(plan.radices)) == n
    odd = tuple(r for r in plan.radices if r % 2)
    pow2 = plan.radices[:len(plan.radices) - len(odd)]
    assert odd == fp.odd_primes(m) and all(plan.values % r == 0 for r in odd)
    # V is the largest 2^k q <= 64, q the odd part of m
    q = int(np.prod(odd))
    assert plan.values % q == 0 and 2 * plan.values > 64
    # the power-of-two radices: at most 16, the fewest passes, the larger
    # first; a radix that does not divide V leaves some lanes a last
    # butterfly fewer
    assert all(r <= 16 and r & (r - 1) == 0 for r in pow2)
    assert len(pow2) == -(-int(np.log2(n // q)) // 4)
    assert list(pow2) == sorted(pow2, reverse=True) and pow2[0] <= 4 * pow2[-1]
    for p in range(len(plan.radices)):
        reads = fp.pass_maps(plan, p)[0]
        real = reads[..., 0] < n // plan.radices[p]
        assert real.sum() == n // plan.radices[p]  # each butterfly once
    assert warps == fp.WIDE_WARPS and plan.max_warps == fp.WIDE_WARPS
    for n_filt in (20, 40):
        for feature_type in ("mfcc", "bark"):
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000,
                               n_filt=n_filt)
            fb = fp.filterbank_plan(filterbank_matrix(p, feature_type).T,
                                    plan.lanes)
            lay = fp.fft_layout(plan, fb, n_filt, p.n_mfcc, p.n_features)
            assert lay.smem_bytes <= fp.SMEM_OPTIN and lay.blocks_per_sm >= 1
            assert lay.warps % plan.warps_per_frame == 0
            assert lay.twiddle == lay.weights == 0  # read through the cache
            assert ct_kernel.ct_body(p, feature_type) == "wide"


def test_source_plan_tables_are_the_python_plans():
    """Each csrc/wide_fft_frontend_<u>.cu holds the plans of its unit, and
    together they are WIDE_PLANS (the warps are the launch's argument)."""
    got = {}
    for u in range(fp.WIDE_UNITS):
        src = (_build.CSRC_DIR / f"wide_fft_frontend_{u}.cu").read_text()
        assert f"TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_{u}, TSC_WIDE_PLANS)" \
            in src
        for n, v, b, rad in re.findall(r"X\((\d+), (\d+), (\d+), ([\d, ]+)\)",
                                       src):
            n_fft = 2 * int(n)
            assert fp.wide_unit(n_fft) == u and n_fft not in got
            got[n_fft] = (int(v), tuple(int(r) for r in rad.split(",")),
                          int(b))
    assert got == {n: plan[:3] for n, plan in fp.WIDE_PLANS.items()}
    assert sorted(p.name for p in _build.CSRC_DIR.glob("wide_fft_frontend_*"
                                                       ".cu")) == sorted(
        f"wide_fft_frontend_{u}.cu" for u in range(fp.WIDE_UNITS))
    assert f"constexpr int kWideThreads = {32 * fp.WIDE_WARPS};" in HEADER


@pytest.mark.parametrize("radix", PRIMES)
def test_odd_dft_on_the_source_tables_is_the_dft(radix):
    c, s = COS_SIN[radix]
    k = np.arange(radix)
    np.testing.assert_allclose(c, np.cos(2 * np.pi * k / radix), atol=6e-8)
    np.testing.assert_allclose(s, np.sin(2 * np.pi * k / radix), atol=6e-8)
    # the float32 values of the float64 ones, each literal exactly
    np.testing.assert_array_equal(
        c, np.cos(2 * np.pi * k / radix).astype(np.float32))
    v = np.random.default_rng(radix).standard_normal((5, radix, 2)) @ [1, 1j]
    want = np.fft.fft(v, axis=-1)
    np.testing.assert_allclose(odd_dft(v, np.float64), want, atol=1e-12)
    np.testing.assert_allclose(odd_dft(v.astype(np.complex64), np.float32),
                               want, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_fft", SIZES)
def test_emulated_passes_equal_rfft(n_fft):
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((4, n_fft)).astype(np.float32)
    frames[1] *= 1e-3
    want = np.fft.rfft(frames.astype(np.float64), axis=-1)
    plan = fp.wide_plan(n_fft)
    got32 = fp.emulate_rfft(frames, plan, _tw(plan, np.complex64),
                            kernel_dft(np.float32))
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got32 - want) <= 1e-4 * scale).all()
    tw64 = plan.twiddle[:, 0] + 1j * plan.twiddle[:, 1]
    got64 = fp.emulate_rfft(frames.astype(np.float64), plan, tw64,
                            kernel_dft(np.float64))
    np.testing.assert_allclose(got64, want, atol=1e-9 * scale.max(), rtol=0)


def _frames(x: np.ndarray, p: ListenerParams) -> np.ndarray:
    """The last n_features frames of n_fft (= window) samples."""
    n_frames = 1 + (x.shape[-1] - p.n_fft) // p.hop_samples
    starts = (n_frames - p.n_features + np.arange(p.n_features)) * p.hop_samples
    return np.stack([x[:, s:s + p.n_fft] for s in starts], 1)


def emulate_features(pcm: np.ndarray, gain: float, p: ListenerParams,
                     feature_type: str) -> np.ndarray:
    """The kernel in float32 numpy: int16 (B, S) -> (B, T, F) features (the
    packed filterbank's segments, summed a filter in the table's order)."""
    c = ct_kernel.CtConstants(p, feature_type, "cpu")
    assert c.body == "wide"
    plan, fb = c.plan, c.fb
    x = pcm.astype(np.float32) * np.float32(gain * (1.0 / 32768.0))
    frames = _frames(x, p)
    b, t = frames.shape[:2]
    xb = fp.emulate_rfft(frames.reshape(b * t, -1), plan,
                         _tw(plan, np.complex64), kernel_dft(np.float32))
    power = ((xb.real ** 2 + xb.imag ** 2) / np.float32(p.n_fft)).astype(
        np.float32)
    energy = power.sum(-1)
    partial = np.stack([(power[:, k0:k0 + cnt] * fb.packed[o0:o0 + cnt]).sum(-1)
                        for k0, o0, cnt in fb.segments], -1)
    mel = np.stack([partial[:, fb.filt_seg[m]:fb.filt_seg[m + 1]].sum(-1)
                    for m in range(p.n_filt)], -1).astype(np.float32)
    feats = np.log(np.maximum(mel, LOG_EPS)) @ dct_t_matrix(p.n_filt)[
        :, :p.n_mfcc]
    feats[:, 0] = np.log(np.maximum(energy, LOG_EPS))
    feats = feats.reshape(b, t, p.n_mfcc)
    if p.use_delta:
        deltas = np.concatenate([np.zeros_like(feats[:, :1]),
                                 np.diff(feats, axis=1)], 1)
        feats = np.concatenate([feats, deltas], -1)
    return feats


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(13)
    return np.clip(rng.standard_normal((2, 16000)) * 6000, -32768,
                   32767).astype(np.int16)


@pytest.mark.parametrize("n_fft,feature_type", [
    (4352, "mfcc"), (4352, "bark"), (10240, "mfcc"), (15872, "mfcc")])
def test_emulated_features_match_the_jax_ct_kernel(pcm, n_fft, feature_type):
    """The kernel's arithmetic against the JAX CT kernel (interpret mode)
    and against ct_frontend_plain, the card's reference: two windows of
    int16 PCM with deltas (23, 12 and 1 frames)."""
    kw = {"n_fft": n_fft, "window_t": n_fft / 16000, "use_delta": True}
    p = ListenerParams(**kw)
    fused = make_fused_frontend(JaxParams(**kw), feature_type, batch_tile=2,
                                interpret=True, dft_mode="ct",
                                emit_deltas=True)
    want = np.asarray(fused(jnp.asarray(pcm), 1.3))
    got = emulate_features(pcm, 1.3, p, feature_type)
    assert got.shape == want.shape == (2, p.n_features, 2 * p.n_mfcc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = ct_kernel.ct_frontend_plain(
        torch.tensor(pcm), 1.3, ct_kernel.CtConstants(p, feature_type, "cpu"),
        p).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


def test_ablation_variants_each_match_the_kernel_sources():
    """dev/wide_ablation.py edits each unit's plan table by text: every
    variant finds every row of its unit and sets its blocks."""
    from tpu_speech_commands_torch.dev import wide_ablation

    units = range(fp.WIDE_UNITS)
    sources = wide_ablation.variant_sources(units)
    assert set(sources) == {(name, u) for name in wide_ablation.VARIANTS
                            for u in units}
    for (name, u), src in sources.items():
        blocks = {int(b) for b in re.findall(r"X\(\d+, \d+, (\d+),", src)}
        assert blocks == {wide_ablation.VARIANTS[name]}
        assert '#include "register_fft.cuh"' in src  # found through -I
    assert {fp.wide_unit(n) for n in wide_ablation.SIZES} <= set(units)
