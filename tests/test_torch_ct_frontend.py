"""The port's CT split frontend (`ops/ct_kernel.py`, `ops/ct_constants.py`)
against the JAX package's CT kernels, run on the CPU.

The same numpy audio, made from a seed, at gain 1.3, goes through the plain
version of the CUDA kernel, `ct_frontend_plain`, and through:
- the three K8 frontends of `tools/dev/` (loaded by file path, their
  import-time `enable_compilation_cache()` made a no-op first), in TPU
  interpret mode at B = 16 (one tile) and the default config, each against
  the instantiation it maps onto;
- K1, `make_fused_frontend(dft_mode="ct")` in interpret mode, at n2 = 6
  (n_fft = window = 768) and n2 = 10 (1280), with deltas, on int16 PCM.

Tolerance: atol 1e-4 / rtol 1e-4 on the features, the bound
tests/test_torch_frontend.py holds the plain frontend to against the JAX
kernels (the K8 scripts claim <= 2e-5 between their variants; the sums run
in another order here).  The CUDA kernel against this plain version on the
card: test_torch_gpu.py.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_speech_commands.ops import make_fused_frontend
from tpu_speech_commands.ops.pallas_frontend import _ct_matrices, _params_key
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands_torch.ops import ct_kernel
from tpu_speech_commands_torch.ops.ct_constants import LANES, ct_matrices
from tpu_speech_commands_torch.ops.ct_kernel import (CtConstants, ct_config_error,
                                                     ct_frontend, ct_frontend_plain)
from tpu_speech_commands_torch.ops.dense_dft_kernel import (
    DenseDftConstants, dense_dft_combined_plain)
from tpu_speech_commands_torch.params import ListenerParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-4
GAIN = 1.3
K1_CONFIGS = {
    "n2=6": {"n_fft": 768, "window_t": 0.048, "use_delta": True},
    "n2=10": {"n_fft": 1280, "window_t": 0.08, "hop_t": 0.04,
              "use_delta": True},
}


@pytest.fixture(scope="module")
def jax_k8():
    """The three K8 scripts of tools/dev, loaded by file path."""
    import tpu_speech_commands.utils.compilation_cache as cc

    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "enable_compilation_cache", lambda *a, **k: None)
    modules = {}
    try:
        for name in ("r3_frontend_variants", "r3_stage2", "r3_widecell"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_dev_{name}", os.path.join(REPO, "tools", "dev",
                                                 f"{name}.py"))
            modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(modules[name])
    finally:
        mp.undo()
    return modules


@pytest.fixture(scope="module")
def audio16():
    return np.random.default_rng(11).standard_normal((16, 16000)).astype(
        np.float32)


@pytest.fixture(scope="module")
def plain16(audio16):
    """ct_frontend_plain at the default config, once per (paired,
    per_piece_mel, time_major)."""
    p = ListenerParams()
    consts = CtConstants(p, "mfcc", "cpu")
    cache = {}

    def get(paired, per_piece, time_major):
        key = (paired, per_piece, time_major)
        if key not in cache:
            cache[key] = ct_frontend_plain(torch.tensor(audio16), GAIN, consts,
                                           p, *key).numpy()
        return cache[key]

    return get


# (script, arguments) -> (paired, per_piece_mel, time_major)
K8_CASES = {
    ("r3_frontend_variants", "concat", "concat"): (False, False, False),
    ("r3_frontend_variants", "reshape", "concat"): (False, False, False),
    ("r3_frontend_variants", "concat", "dup"): (False, True, False),
    ("r3_frontend_variants", "reshape", "dup"): (False, True, False),
    ("r3_stage2", "perres"): (False, False, True),
    ("r3_stage2", "paired"): (True, False, True),
    ("r3_stage2", "ppmel"): (True, True, True),
    ("r3_widecell", "time_major"): (False, False, True),
    ("r3_widecell", "batch_major"): (False, False, False),
}


def _k8_frontend(module, script, args):
    if script == "r3_frontend_variants":
        return module.make_variant(*args, batch_tile=16, interpret=True)
    if script == "r3_stage2":
        return module.make_variant(args[0], batch_tile=16)
    return module.make_widecell(batch_tile=16,
                                time_major=args[0] == "time_major")


@pytest.mark.parametrize("case", sorted(K8_CASES), ids="-".join)
def test_plain_matches_the_k8_frontends(jax_k8, audio16, plain16, case):
    script, *args = case
    fn = _k8_frontend(jax_k8[script], script, args)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(audio16), GAIN))
    got = plain16(*K8_CASES[case])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def k1_outputs():
    """JAX K1 in interpret mode on int16 PCM with deltas, once a config."""
    rng = np.random.default_rng(12)
    pcm = np.clip(rng.standard_normal((8, 16000)) * 6000, -32768,
                  32767).astype(np.int16)
    out = {}
    for name, kw in K1_CONFIGS.items():
        jp = JaxParams(**kw)
        fused = make_fused_frontend(jp, batch_tile=4, interpret=True,
                                    dft_mode="ct", emit_deltas=True)
        out[name] = np.asarray(fused(jnp.asarray(pcm), GAIN))
    return pcm, out


@pytest.mark.parametrize("variant", sorted(ct_kernel.VARIANTS))
@pytest.mark.parametrize("name", sorted(K1_CONFIGS))
def test_plain_matches_jax_k1_beyond_powers_of_two(k1_outputs, name, variant):
    pcm, want = k1_outputs
    p = ListenerParams(**K1_CONFIGS[name])
    paired, per_piece, _ = ct_kernel.VARIANTS[variant]
    got = ct_frontend_plain(torch.tensor(pcm), GAIN, CtConstants(p, "mfcc", "cpu"),
                            p, paired, per_piece).numpy()
    assert got.shape == want[name].shape == (8, p.n_features, 2 * p.n_mfcc)
    np.testing.assert_allclose(got, want[name], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("feature_type", ["mfcc", "bark"])
@pytest.mark.parametrize("n_fft", [768, 1024, 1280])
def test_constants_match_the_jax_constants(feature_type, n_fft):
    """The port's copy of `_ct_matrices`: stage-1 tables, stage-2 packs,
    the permuted filterbank with its energy column and the Nyquist row."""
    jp = JaxParams(n_fft=n_fft, window_t=n_fft / 16000)
    ct_cos, ct_sin, e2a, e2b, filt_half, filt_nyq, dct_t = _ct_matrices(
        _params_key(jp), feature_type)
    m = ct_matrices(n_fft, 20, 16000, feature_type)
    np.testing.assert_allclose(m.stage1, np.stack([ct_cos, ct_sin]), atol=1e-12)
    np.testing.assert_array_equal(m.e2a, e2a)
    np.testing.assert_array_equal(m.e2b, e2b)
    np.testing.assert_array_equal(m.filt_half, filt_half[:, :21])
    np.testing.assert_array_equal(m.filt_nyq, filt_nyq[0, :21])
    np.testing.assert_array_equal(m.dct_t, dct_t)


@pytest.mark.parametrize("paired", [False, True])
def test_stage2_pack_holds_each_residue(paired):
    """[T_re | T_im] @ pack gives the residue's [Xr | Xi], signs and all."""
    m = ct_matrices(768, 20, 16000, "mfcc")
    n2, half = m.n2, m.half
    pack = m.stage2_pack(paired)
    rng = np.random.default_rng(3)
    t_re, t_im = rng.standard_normal((2, LANES))
    for s in range(n2):
        sr = s if s <= half else n2 - s
        sign = 0 if s in (0, half) else (1 if s < half else -1)
        want = t_re @ m.e2a[s] + sign * t_im @ m.e2b[s]
        if paired:
            col = 0 if s <= half else LANES
            mat = pack[sr][:, col:col + LANES]
        else:
            mat = pack[s]
        got = np.concatenate([t_re, t_im if sign else 0 * t_im]) @ mat
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_piece_ranges_cover_every_weight():
    m = ct_matrices(1024, 20, 16000, "mfcc")
    w = m.filt_half.reshape(m.n2, 64, -1)
    r = m.piece_ranges()
    for f in range(21):
        for s in range(m.n2):
            lo, hi = r[f, s]
            nz = np.flatnonzero(w[s, :, f])
            assert (lo, hi) == ((nz[0], nz[-1] + 1) if nz.size else (0, 0))
    assert (r[20] == [0, 64]).all()  # the energy column


def test_host_refusals(monkeypatch):
    """The host refuses from the config, before any launch: outside the
    contract, or where no kernel of route ct has a block that fits.  Above
    n_fft 4096 the wide FFT takes the config (n_fft 4352 and 15872 at the
    default 20 filters), and with 300, 512 or 1000 coefficients too, in
    log-mel mode with the cepstrum kernel after it; a config whose block
    fits nowhere even in log-mel mode (1000 filters on a card whose blocks
    held at most 40,000 bytes) is refused."""
    assert ct_config_error(ListenerParams(n_fft=768, window_t=0.048)) is None
    assert ct_config_error(ListenerParams(n_fft=3072, window_t=0.192)) is None
    assert ct_config_error(ListenerParams(n_fft=4352, window_t=0.272)) is None
    assert ct_config_error(ListenerParams(n_fft=15872, window_t=0.992)) is None
    for n in (300, 512, 1000):
        assert ct_config_error(ListenerParams(
            n_fft=4352, window_t=0.272, n_filt=n, n_mfcc=n)) is None
    monkeypatch.setattr(ct_kernel, "SMEM_OPTIN", 40_000)
    assert "no CUDA kernel of route ct" in ct_config_error(
        ListenerParams(n_fft=4352, window_t=0.272, n_filt=1000, n_mfcc=1000))
    monkeypatch.undo()
    assert "n2 even" in ct_config_error(ListenerParams(window_t=0.05))
    assert "n2 even" in ct_config_error(ListenerParams(n_fft=640,
                                                       window_t=0.04))
    assert "n_mfcc <= n_filt" in ct_config_error(ListenerParams(n_mfcc=24))


def test_wrapper_on_cpu_is_the_plain_version(audio16):
    p = ListenerParams(use_delta=True)
    consts = CtConstants(p, "mfcc", "cpu")
    audio = torch.tensor(audio16[:4])
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ct_frontend(audio, 0.7, consts, p, True, False, True, out_dtype)
        assert got.dtype == out_dtype and got.shape == (30, 4, 40)
        torch.testing.assert_close(
            got, ct_frontend_plain(audio, 0.7, consts, p, True, False, True,
                                   out_dtype), rtol=0, atol=0)
    with pytest.raises(ValueError, match="audio on cpu"):
        # the split forced: route ct has no register body at n_fft 1024
        ct_kernel.ct_frontend_cuda(audio, torch.ones(1), consts, p,
                                   _split=True)


def test_dense_plain_takes_the_gain_and_first_frame_of_the_jax_dense_frontend(
        audio16):
    """The f32 contract of make_fused_frontend(dft_mode="dense"), which
    dev/r4_mxu_stage1.py's dense line times: hop 480 frames 32, the last 31
    kept, gain applied."""
    p = ListenerParams(hop_t=0.03)
    fused = make_fused_frontend(JaxParams(hop_t=0.03), batch_tile=4,
                                interpret=True, dft_mode="dense")
    want = np.asarray(fused(jnp.asarray(audio16[:4]), GAIN))
    got = dense_dft_combined_plain(torch.tensor(audio16[:4]),
                                   DenseDftConstants(p, "cpu"), GAIN, 1)
    assert got.shape == want.shape == (4, 31, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_ablation_cuts_each_match_the_kernel_source_once():
    """dev/ct_ablation.py cuts parts of csrc/ct_frontend.cu by text: each cut
    must still find its text, once."""
    from tpu_speech_commands_torch.dev import ct_ablation

    sources = ct_ablation.variant_sources()
    assert set(sources) == {"base", *ct_ablation.CUTS}
    assert all(src != sources["base"] for name, src in sources.items()
               if name != "base")


def _c_to_python(expr: str) -> str:
    """A C integer expression of csrc/ct_frontend.cu as Python: casts
    dropped, `/` as floor division (every operand is a nonnegative int), and
    each `a ? b : c` (innermost parentheses first) as `(b if a else c)`."""
    import re

    expr = re.sub(r"\((?:size_t|int)\)", "", " ".join(expr.split()))
    expr = expr.replace(" / ", " // ").replace("true", "True").replace(
        "false", "False")

    def ternary(text):
        if "?" not in text:
            return text
        cond, rest = text.split("?", 1)
        depth = 0
        for i, ch in enumerate(rest):
            depth += ch == "?"
            if ch == ":" and depth == 0:
                return (f"(({ternary(rest[:i])}) if ({cond}) else "
                        f"({ternary(rest[i + 1:])}))")
            depth -= ch == ":" and depth > 0
        raise ValueError(f"no ':' for the '?' in {text!r}")

    inner = re.compile(r"\(([^()]*\?[^()]*)\)")
    while inner.search(expr):
        expr = inner.sub(lambda m: "(" + ternary(m.group(1)) + ")", expr)
    return ternary(expr)


def _split_source_functions():
    """csrc/ct_frontend.cu's tile constants and its shared-memory functions
    (smem_floats, coef_floats, sq_pitch, mel_pitch), evaluated from the
    source's text."""
    import re

    from tpu_speech_commands_torch.ops import _build

    src = (_build.CSRC_DIR / "ct_frontend.cu").read_text()
    env = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
           for name in ("kLanes", "kBK", "kStages")}
    bms = re.search(r"constexpr int kBms\[\] = \{([\d, ]+)\};", src).group(1)
    env["kBms"] = tuple(int(x) for x in bms.split(","))
    for name in ("mel_pitch", "sq_pitch", "coef_floats", "smem_floats"):
        m = re.search(rf"inline \w+ {name}\(([^)]*)\) \{{\s*(.*?)\}}\n", src,
                      re.S)
        params = [a.split()[-1] for a in m.group(1).split(",")]
        lines = [ln.strip() for ln in m.group(2).strip().rstrip(";").split(";")]
        body = [f"    {ln.split('=', 1)[0].split()[-1]} = "
                f"{_c_to_python(ln.split('=', 1)[1])}"
                for ln in lines[:-1]]
        body.append(f"    return {_c_to_python(lines[-1][len('return '):])}")
        exec(f"def {name}({', '.join(params)}):\n" + "\n".join(body), env)
    return env


def test_split_shared_memory_mirror_is_the_kernel_source():
    """`ct_kernel.split_smem_bytes` and `split_fits` route configs from a
    Python copy of csrc/ct_frontend.cu's shared-memory sizes: its kStages,
    kBK and kBms, and smem_floats (with sq_pitch and mel_pitch) evaluated
    from the source's text, agree with the copy at every block size, every
    CT-eligible n_fft up to 8192 and 1 to 256 filters, without and with the
    per-piece mel, and with few or many coefficients (their own region
    where they outnumber the idle T, ring and power space); above n_fft
    4096 the (F, F) instantiation fits no block at any filter count while
    the (F, T) one fits at every one up to 256; and at n_fft 4352 the (F,
    T) one takes 64 rows with 300 filters and coefficients and 32 with 512,
    both in the idle space, and 32 with 600, in a region of their own
    (split-dup serves them only as the A/B, `per_piece_mel=True`: route ct
    takes the wide FFT in log-mel mode and the cepstrum kernel)."""
    src = _split_source_functions()
    assert (src["kStages"], src["kBK"], src["kLanes"], src["kBms"]) == (
        ct_kernel._SPLIT_STAGES, ct_kernel._SPLIT_BK, LANES,
        ct_kernel._SPLIT_BMS)
    for n_fft in range(256, 8192 + 1, 256):
        for n_filt in (1, 13, 20, 40, 64, 128, 230, 256, 300, 512, 600):
            for n_mfcc in sorted({1, min(n_filt, 13), n_filt}):
                for bm in src["kBms"]:
                    for ppmel in (False, True):
                        assert 4 * src["smem_floats"](
                            bm, n_fft, n_filt, n_mfcc, False, ppmel) == \
                            ct_kernel.split_smem_bytes(bm, n_fft, n_filt,
                                                       n_mfcc, ppmel)
            p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000,
                               n_filt=n_filt, n_mfcc=min(n_filt, 13))
            if n_fft > 4096 and n_filt <= 256:
                assert not ct_kernel.split_fits(p)
                assert ct_kernel.split_fits(p, per_piece_mel=True)
    for n, bm, own in ((300, 64, False), (512, 32, False), (600, 32, True)):
        p = ListenerParams(n_fft=4352, window_t=0.272, n_filt=n, n_mfcc=n)
        assert ct_kernel.split_rows(p, per_piece_mel=True) == bm
        assert ct_kernel.ct_body(p) == "wide" and ct_kernel.ct_cepstrum(p)
        assert bm * n > 2 * 128 * (bm + 4)  # more than T alone holds
        assert src["coef_floats"](bm, 4352, n, False, True) == (
            bm * n if own else 0)
    assert src["coef_floats"](64, 1024, 20, False, False) == 0
    # the paired form, which no route sizes, parses too
    assert src["smem_floats"](64, 1024, 20, 20, True, True) == (
        2 * 64 + 2 * 128 * 68 + 3 * 8 * 256 + 64 * 257 + 64 * 21 + 64)


def test_split_dup_plain_matches_jax_k1_above_4096():
    """n_fft = window = 4352 (n2 = 34, 23 frames), above the mixed-radix
    FFT's plans: route ct's body is the wide FFT; the split's (F, T)
    instantiation ("split-dup", per_piece_mel=True, the A/B baseline and
    the body of configs the wide block does not fit) has a plain version
    that holds to JAX K1 (dft_mode="ct", interpret mode) on two windows of
    int16 PCM with deltas, at the file's RTOL / ATOL."""
    kw = {"n_fft": 4352, "window_t": 0.272, "use_delta": True}
    p = ListenerParams(**kw)
    assert ct_kernel.ct_body(p) == "wide"
    rng = np.random.default_rng(13)
    pcm = np.clip(rng.standard_normal((2, 16000)) * 6000, -32768,
                  32767).astype(np.int16)
    fused = make_fused_frontend(JaxParams(**kw), batch_tile=2, interpret=True,
                                dft_mode="ct", emit_deltas=True)
    want = np.asarray(fused(jnp.asarray(pcm), GAIN))
    got = ct_frontend_plain(torch.tensor(pcm), GAIN,
                            CtConstants(p, "mfcc", "cpu"), p,
                            per_piece_mel=True).numpy()
    assert got.shape == want.shape == (2, 23, 2 * p.n_mfcc)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_split_dup_plain_matches_jax_k1_with_300_coefficients():
    """n_fft = window = 4352 with 300 filters and 300 coefficients (more
    than one residue's T holds, where the coefficients were kept): route
    ct's body is the wide FFT in log-mel mode with the cepstrum kernel
    after it (tests/test_torch_cepstrum.py); split-dup, its A/B baseline
    (`per_piece_mel=True`), has a plain version that holds to JAX K1
    (dft_mode="ct", interpret mode) on two windows of f32 audio, at the
    file's RTOL / ATOL."""
    kw = {"n_fft": 4352, "window_t": 0.272, "n_filt": 300, "n_mfcc": 300}
    p = ListenerParams(**kw)
    assert ct_kernel.ct_body(p) == "wide" and ct_kernel.ct_cepstrum(p)
    assert ct_config_error(p) is None
    rng = np.random.default_rng(17)
    audio = (0.2 * rng.standard_normal((2, 16000))).astype(np.float32)
    fused = make_fused_frontend(JaxParams(**kw), batch_tile=2, interpret=True,
                                dft_mode="ct")
    want = np.asarray(fused(jnp.asarray(audio), GAIN))
    got = ct_frontend_plain(torch.tensor(audio), GAIN,
                            CtConstants(p, "mfcc", "cpu"), p,
                            per_piece_mel=True).numpy()
    assert got.shape == want.shape == (2, 23, 300)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
