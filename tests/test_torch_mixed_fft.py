"""The mixed-radix register FFT of route ct (`csrc/mixed_fft_frontend.cu`,
plan `ops/fft_plan.py::mixed_plan`), on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py holds it to the
plain version there).  Here a numpy emulation of its passes, on the tables
it reads and with its in-register DFTs (the odd radices' pairs p_r, q_r
with the source's own cos and sin constants), is held to:
- np.fft.rfft in float64 at every n_fft the kernel takes: atol 1e-4 times
  the frame's max |X| in float32 (as tests/test_torch_fft_plan.py holds the
  register body), 1e-9 in float64;
- the JAX package's CT kernel (`make_fused_frontend(dft_mode="ct")`) in
  interpret mode, features at n_fft = window = 768 and 1536, mfcc and bark,
  with deltas: RTOL / ATOL 1e-4, tests/test_torch_ct_frontend.py's bound.
And the plan's invariants at every size: a lane holds whole butterflies of
every pass, V <= 64, the power-of-two radices at most 16 in the fewest
passes and the order with the fewest shared-memory wavefronts, one pass an
odd prime factor, the block fits SMEM_OPTIN at 20 and 40 filters, and the
CUDA source's plan table equals the Python one.
"""
import itertools
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
from tpu_speech_commands_torch.dev.ct_ablation import inlined_source
from tpu_speech_commands_torch.ops import fft_plan as fp
from tpu_speech_commands_torch.ops.ct_kernel import (CtConstants,
                                                     ct_frontend_plain)
from tpu_speech_commands_torch.params import ListenerParams

SIZES = sorted(fp.MIXED_PLANS)
# the kernel with the register body it shares (csrc/register_fft.cuh)
SOURCE = inlined_source("mixed_fft_frontend.cu")
RTOL, ATOL = 1e-4, 1e-4


def _source_cos_sin():
    """R -> (cos, sin) float32 tables of the source's cos_sin<R>."""
    tables = {}
    for r, c, s in re.findall(
            r"R == (\d+)\) \{\s*constexpr float c\[\d+\] = \{([^}]*)\};\s*"
            r"constexpr float s\[\d+\] = \{([^}]*)\};", SOURCE):
        tables[int(r)] = tuple(np.array([float(x.strip().rstrip("f"))
                                         for x in t.split(",")], np.float32)
                               for t in (c, s))
    last = re.search(r"\} else \{\s*constexpr float c\[13\] = \{([^}]*)\};\s*"
                     r"constexpr float s\[13\] = \{([^}]*)\};", SOURCE)
    tables[13] = tuple(np.array([float(x.strip().rstrip("f"))
                                 for x in t.split(",")], np.float32)
                       for t in last.groups())
    return tables


COS_SIN = _source_cos_sin()


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


@pytest.mark.parametrize("radix", [3, 5, 7, 11, 13])
def test_odd_dft_on_the_source_tables_is_the_dft(radix):
    c, s = COS_SIN[radix]
    k = np.arange(radix)
    np.testing.assert_allclose(c, np.cos(2 * np.pi * k / radix), atol=6e-8)
    np.testing.assert_allclose(s, np.sin(2 * np.pi * k / radix), atol=6e-8)
    v = np.random.default_rng(radix).standard_normal((5, radix, 2)) @ [1, 1j]
    want = np.fft.fft(v, axis=-1)
    np.testing.assert_allclose(odd_dft(v, np.float64), want, atol=1e-12)
    np.testing.assert_allclose(odd_dft(v.astype(np.complex64), np.float32),
                               want, atol=1e-5)


@pytest.mark.parametrize("n_fft", SIZES)
def test_emulated_passes_equal_rfft(n_fft):
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((4, n_fft)).astype(np.float32)
    frames[1] *= 1e-3
    want = np.fft.rfft(frames.astype(np.float64), axis=-1)
    plan = fp.mixed_plan(n_fft)
    got32 = fp.emulate_rfft(frames, plan, _tw(plan, np.complex64),
                            kernel_dft(np.float32))
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got32 - want) <= 1e-4 * scale).all()
    tw64 = plan.twiddle[:, 0] + 1j * plan.twiddle[:, 1]
    got64 = fp.emulate_rfft(frames.astype(np.float64), plan, tw64,
                            kernel_dft(np.float64))
    np.testing.assert_allclose(got64, want, atol=1e-9 * scale.max(), rtol=0)


def _odd_factors(m: int):
    out, q, f = [], m, 3
    while q % 2 == 0:
        q //= 2
    while q > 1:
        while q % f == 0:
            out.append(f)
            q //= f
        f += 2
    return out


def _wavefronts(plan, radices):
    """Shared-memory wavefronts of every warp-wide access of the passes
    with `radices` (the plan's lanes, values and pitch), as
    test_torch_fft_plan.py counts them: per half-warp, the most distinct
    float2 slots in one bank pair."""
    q = fp.build_plan(plan.n_fft, plan.values, tuple(radices),
                      plan.min_blocks, plan.warps)
    last, total = len(radices) - 1, 0
    for p in range(len(radices)):
        reads, writes, _ = fp.pass_maps(q, p)
        for idx, swizzled, counted in ((reads, True, p > 0),
                                       (writes, p < last, True)):
            if not counted:
                continue
            for b in range(idx.shape[1]):
                for r in range(idx.shape[2]):
                    slots = [(lane // q.lanes) * q.pitch + int(
                        fp.swizzle(idx[lane % q.lanes, b, r]) if swizzled
                        else idx[lane % q.lanes, b, r]) for lane in range(32)]
                    for half in (slots[:16], slots[16:]):
                        banks = {}
                        for sl in set(half):
                            banks.setdefault(sl % 16, set()).add(sl)
                        total += max(len(v) for v in banks.values())
    return total


@pytest.mark.parametrize("n_fft", SIZES)
def test_plan_invariants(n_fft):
    plan = fp.mixed_plan(n_fft)
    n, m = n_fft // 2, n_fft // 256
    assert n_fft % 256 == 0 and m & (m - 1) and plan.n == n
    assert plan.lanes * plan.values == n and plan.lanes <= 32
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.values <= 64
    assert int(np.prod(plan.radices)) == n
    assert all(plan.values % r == 0 for r in plan.radices)
    odd = [r for r in plan.radices if r % 2]
    pow2 = [r for r in plan.radices if r % 2 == 0]
    assert odd == _odd_factors(m) and plan.radices[-len(odd):] == tuple(odd)
    assert all(r <= 16 and r & (r - 1) == 0 for r in pow2)
    # V is the largest 2^k q <= 64, and its power-of-two part sets the
    # largest radix: the fewest power-of-two passes it allows
    q = int(np.prod(odd))
    assert 2 * plan.values > 64 or n % (2 * plan.values)
    largest = min(16, plan.values // q)
    assert largest & (largest - 1) == 0
    assert len(pow2) == -(-int(np.log2(n // q)) // int(np.log2(largest)))
    warps = fp.MIXED_PLANS[n_fft][3]
    assert plan.warps == warps
    for n_filt in (20, 40):
        p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000, n_filt=n_filt)
        fb = fp.filterbank_plan(filterbank_matrix(p, "mfcc").T, plan.lanes)
        lay = fp.fft_layout(plan, fb, n_filt, p.n_mfcc, p.n_features)
        assert lay.smem_bytes <= fp.SMEM_OPTIN and lay.blocks_per_sm >= 1
        assert lay.warps == warps
        if n_filt == 20:
            # the launch bounds promise 2 blocks where the frame slots leave
            # room for 3 or more blocks of 4 warps, else 1
            four = fp.fft_layout(plan, fb, n_filt, p.n_mfcc, p.n_features, 4)
            roomy = fp.SMEM_PER_SM // (four.smem_bytes + fp.SMEM_RESERVED) >= 3
            assert plan.min_blocks == (2 if roomy else 1)


@pytest.mark.parametrize("n_fft", SIZES)
def test_power_of_two_order_takes_the_fewest_wavefronts(n_fft):
    plan = fp.mixed_plan(n_fft)
    pow2 = tuple(r for r in plan.radices if r % 2 == 0)
    odd = plan.radices[len(pow2):]
    mine = _wavefronts(plan, plan.radices)
    others = [_wavefronts(plan, order + odd)
              for order in set(itertools.permutations(pow2))]
    assert mine == min(others)
    # two wavefronts (the least for 32 float2) for most accesses
    accesses = 2 * len(plan.radices) - 1
    assert mine <= 1.3 * 2 * accesses * plan.values


def test_source_plan_table_is_the_python_plan():
    rows = re.findall(r"X\((\d+), (\d+), (\d+), ([\d, ]+)\)", SOURCE)
    got = {2 * int(n): (int(v), tuple(int(r) for r in rad.split(",")),
                        int(b)) for n, v, b, rad in rows}
    assert got == {n: plan[:3] for n, plan in fp.MIXED_PLANS.items()}
    assert "static constexpr int kMinBlocks = B_;" in SOURCE
    assert "constexpr int kMaxThreads = 256;" in SOURCE and fp.WARPS == 8


def _frames(x: np.ndarray, p: ListenerParams) -> np.ndarray:
    """The last n_features frames of n_fft (= window) samples."""
    n_frames = 1 + (x.shape[-1] - p.n_fft) // p.hop_samples
    starts = (n_frames - p.n_features + np.arange(p.n_features)) * p.hop_samples
    return np.stack([x[:, s:s + p.n_fft] for s in starts], 1)


def emulate_features(pcm: np.ndarray, gain: float, p: ListenerParams,
                     feature_type: str) -> np.ndarray:
    """The kernel in float32 numpy: int16 (B, S) -> (B, T, F) features."""
    c = CtConstants(p, feature_type, "cpu")
    assert c.body == "register"
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


JAX_CASES = {
    "768": {"n_fft": 768, "window_t": 0.048, "use_delta": True},
    "1536": {"n_fft": 1536, "window_t": 0.096, "hop_t": 0.016,
             "use_delta": True},
}


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(13)
    return np.clip(rng.standard_normal((4, 16000)) * 6000, -32768,
                   32767).astype(np.int16)


@pytest.mark.parametrize("feature_type", ["mfcc", "bark"])
@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_emulated_features_match_the_jax_ct_kernel(pcm, name, feature_type):
    """The kernel's arithmetic against the JAX CT kernel (interpret mode)
    and against ct_frontend_plain, the card's reference."""
    kw = JAX_CASES[name]
    p = ListenerParams(**kw)
    fused = make_fused_frontend(JaxParams(**kw), feature_type, batch_tile=4,
                                interpret=True, dft_mode="ct",
                                emit_deltas=True)
    want = np.asarray(fused(jnp.asarray(pcm), 1.3))
    got = emulate_features(pcm, 1.3, p, feature_type)
    assert got.shape == want.shape == (4, p.n_features, 2 * p.n_mfcc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = ct_frontend_plain(torch.tensor(pcm), 1.3,
                              CtConstants(p, feature_type, "cpu"), p).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


def test_ablation_variants_each_match_the_kernel_source():
    """dev/mixed_ablation.py edits csrc/mixed_fft_frontend.cu (its header
    inlined) by text: each
    variant finds its text as often as it expects, and each differs."""
    from tpu_speech_commands_torch.dev import mixed_ablation

    sources = mixed_ablation.variant_sources()
    assert set(sources) == {"base", *mixed_ablation.VARIANTS}
    assert len(set(sources.values())) == len(sources)
