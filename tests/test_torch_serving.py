"""The port's batch scorer against the JAX package's, on real data.

Both scorers load the same pretrained checkpoint; the JAX one runs its
Pallas kernels in interpret mode.  The eight labelled example clips are read
as int16 PCM.  Tolerances:
- f32 scores: rtol 1e-4 / atol 1e-5, the bound tests/test_serving.py holds
  the fused JAX scorer to against its plain forward;
- bf16 scores: atol 5e-2, the bound tests/test_serving.py allows bf16.

The scorer on the card: test_torch_gpu.py.
"""
import glob
import json
import os
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_speech_commands.serving import make_batch_scorer as jax_scorer
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.serving import make_batch_scorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {m: os.path.join(REPO, "pretrained", f"direction_{m}.npz")
         for m in ("simple_gru", "simple_lstm")}
RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 5e-2


@pytest.fixture(scope="module")
def clips():
    """(8, 16000) int16 example clips, left-padded or tail-trimmed, and the
    label in each file name."""
    audio, labels = [], []
    for path in sorted(glob.glob(os.path.join(REPO, "example", "*.wav"))):
        with wave.open(path, "rb") as wf:
            pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        pcm = pcm[-16000:]
        audio.append(np.pad(pcm, (16000 - len(pcm), 0)))
        labels.append(os.path.basename(path).split("_")[0])
    assert len(audio) == 8
    return np.stack(audio), labels


@pytest.fixture(scope="module")
def jax_scorers():
    """JAX interpret-mode scorers, built once per checkpoint and dtype."""
    return {
        (m, dt): jax_scorer(path, batch_tile=4, classifier_tile=4,
                            interpret=True, use_pallas=True,
                            compute_dtype=dt)
        for m, path in CKPTS.items() for dt in (jnp.float32, jnp.bfloat16)
    }


@pytest.mark.parametrize("model_type", sorted(CKPTS))
def test_example_clips_match_jax_and_labels(clips, jax_scorers, model_type):
    audio, labels = clips
    scorer = make_batch_scorer(CKPTS[model_type], "cpu")
    assert scorer.paths == {"frontend": "torch", "classifier": "torch"}
    got = scorer(audio).numpy()
    want = np.asarray(jax_scorers[model_type, jnp.float32](jnp.asarray(audio)))
    assert got.shape == (8, 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert [scorer.classes[i] for i in got.argmax(-1)] == labels


@pytest.mark.parametrize("model_type", sorted(CKPTS))
def test_bf16_matches_jax_bf16(clips, jax_scorers, model_type):
    audio, labels = clips
    scorer = make_batch_scorer(CKPTS[model_type], "cpu", torch.bfloat16)
    got = scorer(audio).numpy()
    want = np.asarray(jax_scorers[model_type, jnp.bfloat16](jnp.asarray(audio)))
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)
    assert [scorer.classes[i] for i in got.argmax(-1)] == labels


@pytest.mark.parametrize("model_type", sorted(CKPTS))
def test_odd_batch_int16_and_gain(clips, jax_scorers, model_type):
    """B = 7 (no tile multiple), int16 PCM with a gain: the int16 decode
    comes before the gain in both packages."""
    audio = clips[0][:7]
    scorer = make_batch_scorer(CKPTS[model_type], "cpu")
    for gain in (None, 0.5):
        got = scorer(audio, gain).numpy()
        want = np.asarray(
            jax_scorers[model_type, jnp.float32](jnp.asarray(audio), gain))
        assert got.shape == (7, 5)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    as_float = audio.astype(np.float32) / 32768.0
    np.testing.assert_allclose(scorer(audio, 0.5).numpy(),
                               scorer(as_float * 0.5).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_scorer_immune_to_later_checkpoint_loads(tmp_path, clips):
    """A built scorer keeps its checkpoint's params even after another load
    rewrites the global pr (same feature geometry, other filterbank)."""
    from tpu_speech_commands_torch.export.inference_loader import load_native

    audio = clips[0]
    scorer = make_batch_scorer(CKPTS["simple_gru"], "cpu")
    before = scorer(audio)
    data = dict(np.load(CKPTS["simple_lstm"]))
    meta = json.loads(bytes(data["__meta__"]))
    meta["params"]["n_filt"] = 24
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    other = tmp_path / "other.npz"
    np.savez(other, **data)
    load_native(str(other))
    assert pr.n_filt == 24
    torch.testing.assert_close(scorer(audio), before, rtol=0, atol=0)
    assert scorer.params.n_filt == 20


@pytest.mark.parametrize("model_type", sorted(CKPTS))
def test_load_native_predictor_matches_jax(model_type):
    """Features -> scores through each package's checkpoint loader, on
    (7, 30, 20) features made from a seed."""
    from tpu_speech_commands.export.inference_loader import (
        load_native as jax_load_native,
    )
    from tpu_speech_commands_torch.export.inference_loader import load_native

    feats = np.random.default_rng(5).standard_normal((7, 30, 20)).astype(
        np.float32)
    port = load_native(CKPTS[model_type])
    jax_pred = jax_load_native(CKPTS[model_type])
    assert (port.model_type, port.num_classes, port.classes) == (
        jax_pred.model_type, jax_pred.num_classes, jax_pred.classes)
    assert port.meta == jax_pred.meta
    np.testing.assert_allclose(port(feats).numpy(), jax_pred(feats),
                               rtol=RTOL, atol=ATOL)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch_scorer(CKPTS["simple_gru"], "cuda")


def test_cnn_checkpoint_is_refused():
    path = os.path.join(REPO, "pretrained", "direction_simple_cnn.npz")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_batch_scorer(path, "cpu")
