"""The frontend route a config takes on the card (`frontend_route`), and the
port's scorer against the JAX scorer at a config of each route's class.

- "fft": n_fft a power of two, also with a window longer than n_fft;
- "ct": the JAX CT kernel's configs (`_ct_eligible`) whose n_fft is not a
  power of two, on the mixed-radix FFT up to n_fft 4096 and the CT split's
  (F, T) instantiation above it (`ct_body`), and refused from the config
  where no kernel of the route takes it;
- "torch": every other config, where the JAX scorer, too, runs no Pallas
  kernel (its "xla" frontend).

The scorers load a fresh simple_gru checkpoint that the JAX package saves
with its `pr` set to the config; the JAX one runs its Pallas kernels in
interpret mode.  Scores within tests/test_torch_serving.py's RTOL / ATOL.
The scorers on the card: test_torch_gpu.py and chip_smoke.py.
"""
import glob
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech_commands.ops.pallas_frontend import _ct_eligible
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands.serving import make_batch_scorer as jax_scorer
from tpu_speech_commands_torch.ops import ct_kernel
from tpu_speech_commands_torch.ops.ct_constants import ct_eligible
from tpu_speech_commands_torch.ops.frontend_kernel import (MfccFrontend,
                                                           frontend_route)
from tpu_speech_commands_torch.params import ListenerParams, pr
from tpu_speech_commands_torch.serving import make_batch_scorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
# config -> (route, the JAX scorer's frontend path)
ROUTE_CASES = {
    "n_fft=window=768": ({"n_fft": 768, "window_t": 0.048}, "ct", "pallas-ct"),
    "window 1200 > n_fft 1024": ({"window_t": 0.075}, "fft", "xla"),
    "n_fft=400": ({"n_fft": 400, "window_t": 0.025}, "torch", "xla"),
}


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """Checkpoint loads write the port's own `pr`, which tests/conftest.py
    does not restore."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _grid():
    for n_fft in (256, 384, 400, 512, 640, 768, 1000, 1024, 1280, 1536, 2048):
        for window in (n_fft // 2, 400, n_fft, 1200, 2 * n_fft):
            for hop_t in (0.01, 0.032):
                yield dict(n_fft=n_fft, window_t=window / 16000, hop_t=hop_t)


def test_route_grid_plain_only_where_the_jax_scorer_runs_no_kernel():
    routes = {}
    for kw in _grid():
        p = ListenerParams(**kw)
        route = frontend_route(p)
        routes[route] = routes.get(route, 0) + 1
        jax_eligible = _ct_eligible(JaxParams(**kw))
        assert ct_eligible(p) == jax_eligible
        if route == "torch":
            assert not jax_eligible
        n = p.n_fft
        assert (route == "fft") == (n & (n - 1) == 0)
        assert (route == "ct") == (jax_eligible and n & (n - 1) != 0)
    assert set(routes) == {"fft", "ct", "torch"}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_of_each_class(name):
    kw, route, _ = ROUTE_CASES[name]
    p = ListenerParams(**kw)
    assert frontend_route(p) == route
    assert MfccFrontend(p, "mfcc", "cpu").route == route
    assert MfccFrontend(p, "mfcc", "cpu", fast_math=True).route == "fast_math"


def test_cuda_frontend_refuses_only_what_its_route_cannot_take(monkeypatch):
    """On a machine without CUDA: a config a kernel route cannot take raises
    ValueError before the device is looked at; the others get as far as
    the device check (RuntimeError)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="n_mfcc <= n_filt"):
        MfccFrontend(ListenerParams(n_fft=768, window_t=0.048, n_mfcc=24),
                     "mfcc", "cuda")
    for kw, _, _ in ROUTE_CASES.values():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MfccFrontend(ListenerParams(**kw), "mfcc", "cuda")


# every CT-eligible n_fft that is not a power of two, up to the longest
# window a 1 s buffer holds (15872, one frame)
CT_SIZES = [n for n in range(768, 15873, 256) if n & (n - 1)]


@pytest.mark.parametrize("n_fft", CT_SIZES)
def test_ct_body_each_n_fft_takes(n_fft):
    """Route ct's kernel from the config: the mixed-radix FFT for every
    CT-eligible n_fft up to 4096 that is not a power of two (2816 .. 3840
    too, which the CT split's (F, F) instantiation refuses); above it,
    where the mixed FFT has no plan and the (F, F) power rows fit no block,
    the wide FFT (a frame over two or four warps)."""
    p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000)
    assert frontend_route(p) == "ct"
    body = ct_kernel.ct_body(p)
    assert body == ("register" if n_fft <= 4096 else "wide")
    assert ct_kernel.ct_config_error(p) is None
    assert MfccFrontend(p, "mfcc", "cpu").body == body
    assert not ct_kernel.split_fits(p) or n_fft <= 4096


def test_ct_body_takes_the_split_where_the_register_block_does_not_fit():
    """230 filters at n_fft 768: the 230 x 230 DCT leaves the mixed-radix
    block no room, the split's rows of 32 frames still fit."""
    p = ListenerParams(n_fft=768, window_t=0.048, n_filt=230)
    assert ct_kernel.ct_body(p) == "split" and ct_kernel.split_fits(p)
    assert ct_kernel.ct_body(ListenerParams(n_fft=768, window_t=0.048,
                                            n_filt=200)) == "register"


def test_ct_refuses_from_the_config_before_any_launch(monkeypatch):
    """A config no kernel of route ct takes raises ValueError when the
    frontend is built for CUDA, before the device is looked at: 1000
    filters and coefficients at n_fft 4352 (no block of the split fits),
    or more coefficients than filters; on the CPU it runs the plain chain.
    n_fft 4352 with 300 or 512 coefficients (more than one residue's T
    holds: they take the idle T, ring and squares space), and n_fft 4352
    and 15872
    at 20 filters, get as far as the device check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = ListenerParams(n_fft=4352, window_t=0.272, n_filt=1000, n_mfcc=1000)
    with pytest.raises(ValueError, match="no CUDA kernel of route ct"):
        MfccFrontend(p, "mfcc", "cuda")
    with pytest.raises(ValueError, match="n_mfcc <= n_filt"):
        MfccFrontend(ListenerParams(n_fft=4352, window_t=0.272, n_filt=300,
                                    n_mfcc=301), "mfcc", "cuda")
    for kw in ({"n_fft": 2816}, {"n_fft": 3840}, {"n_fft": 4352},
               {"n_fft": 15872}, {"n_fft": 4352, "n_filt": 300, "n_mfcc": 300},
               {"n_fft": 4352, "n_filt": 512, "n_mfcc": 512}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MfccFrontend(ListenerParams(window_t=kw["n_fft"] / 16000, **kw),
                         "mfcc", "cuda")
    fe = MfccFrontend(p, "mfcc", "cpu")
    assert fe.route == "ct" and fe.body is None
    assert fe(torch.zeros(2, 16000)).shape == (2, p.n_features, p.n_mfcc)
    p300 = ListenerParams(n_fft=4352, window_t=0.272, n_filt=300, n_mfcc=300)
    fe = MfccFrontend(p300, "mfcc", "cpu")
    assert fe.route == "ct" and fe.body == "split-dup"
    assert fe(torch.zeros(2, 16000)).shape == (2, p300.n_features, 300)


@pytest.fixture(scope="module")
def clips():
    audio = []
    for path in sorted(glob.glob(os.path.join(REPO, "example", "*.wav"))):
        with wave.open(path, "rb") as wf:
            pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        pcm = pcm[-16000:]
        audio.append(np.pad(pcm, (16000 - len(pcm), 0)))
    return np.stack(audio)[:6]


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_scorer_matches_jax_at_each_route(tmp_path, clips, name):
    from tpu_speech_commands.optim import get_optimizer
    from tpu_speech_commands.params import pr as jax_pr
    from tpu_speech_commands.training import create_train_state, save_checkpoint

    kw, route, jax_path = ROUTE_CASES[name]
    jax_pr.override(kw)
    classes = ["background", "left", "right", "up", "down"]
    tx = get_optimizer("adam", 1e-3, decay_type=None)
    _, state = create_train_state("simple_gru", len(classes), tx,
                                  jax.random.PRNGKey(2))
    path = str(tmp_path / "gru.npz")
    save_checkpoint(path, state, {
        "model_type": "simple_gru", "num_classes": len(classes),
        "classes": classes, "params": jax_pr.to_dict(),
        "feature_type": "mfcc"})
    reference = jax_scorer(path, batch_tile=2, classifier_tile=2,
                           interpret=True, use_pallas=True)
    assert reference.paths["frontend"].split("(")[0] == jax_path
    want = np.asarray(reference(jnp.asarray(clips), 0.7))
    scorer = make_batch_scorer(path, "cpu")
    assert scorer.frontend.route == route
    assert scorer.params.n_fft == ListenerParams(**kw).n_fft
    got = scorer(clips, 0.7).numpy()
    assert got.shape == (6, 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
