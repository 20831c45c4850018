"""The port's data layer (`tpu_speech_commands_torch/data/`, `utils/`)
against the JAX package's, on the CPU.

- `load_wav` on the repo's example clips and on written 8 / 16 / 24 / 32-bit,
  stereo, 8 kHz and WAVE_FORMAT_EXTENSIBLE files: equal arrays (the same
  numpy decode and scipy resampling);
- the two `make_synthetic_dataset` copies write byte-identical files from
  one seed;
- `get_dataset` and `get_audio_dataset`: the same labels, order and val
  split; features within atol 1e-4 / rtol 1e-4 (the bound
  tests/test_torch_frontend.py holds the plain frontend to against JAX);
  raw audio equal;
- `batch_iterator`: the same batches; the packed cache is not read across
  packages (its fingerprint names the port and the params).
"""
import glob
import os
import struct
import wave

import numpy as np
import pytest
import torch

from tpu_speech_commands.data import dataset as jax_dataset
from tpu_speech_commands.data.synthetic import make_synthetic_dataset as jax_synth
from tpu_speech_commands.data.wav import load_wav as jax_load_wav
from tpu_speech_commands.frontend import Frontend as JaxFrontend
from tpu_speech_commands.utils import common as jax_common
from tpu_speech_commands_torch.data import dataset
from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
from tpu_speech_commands_torch.data.wav import load_wav
from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.utils import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["background", "left", "right"]
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    make_synthetic_dataset(root, CLASSES, samples_per_class=5, seed=3)
    return root


def _write_wav(path, data: bytes, channels, width, rate):
    with wave.open(path, "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(rate)
        wf.writeframes(data)


def _write_extensible(path, pcm16: np.ndarray, rate=16000):
    """A WAVE_FORMAT_EXTENSIBLE header (stdlib wave refuses it)."""
    data = pcm16.astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHHHHIH14s", 0xFFFE, 1, rate, rate * 2, 2, 16, 22,
                      16, 0, 1, b"\x00" * 14)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data))
                + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(data)) + data)


def test_load_wav_matches_jax(tmp_path):
    paths = sorted(glob.glob(os.path.join(REPO, "example", "*.wav")))
    rng = np.random.default_rng(5)
    pcm = (rng.standard_normal(4000) * 5000).astype(np.int16)
    _write_wav(str(tmp_path / "s16_8k.wav"), pcm.tobytes(), 1, 2, 8000)
    _write_wav(str(tmp_path / "stereo.wav"),
               np.stack([pcm, pcm[::-1]], 1).tobytes(), 2, 2, 16000)
    _write_wav(str(tmp_path / "u8.wav"),
               (pcm // 256 + 128).astype(np.uint8).tobytes(), 1, 1, 16000)
    _write_wav(str(tmp_path / "s32.wav"),
               (pcm.astype(np.int32) << 16).astype("<i4").tobytes(), 1, 4,
               16000)
    s24 = (pcm.astype(np.int32) << 8)
    _write_wav(str(tmp_path / "s24.wav"), np.stack(
        [s24 & 255, (s24 >> 8) & 255, (s24 >> 16) & 255], 1).astype(
        np.uint8).tobytes(), 1, 3, 16000)
    _write_extensible(str(tmp_path / "ext.wav"), pcm)
    paths += sorted(str(p) for p in tmp_path.glob("*.wav"))
    assert len(paths) == 8 + 6
    for path in paths:
        got, want = load_wav(path), jax_load_wav(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_synthetic_copies_write_identical_files(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    make_synthetic_dataset(a, CLASSES + ["custom"], samples_per_class=4, seed=7,
                           hard=True)
    jax_synth(b, CLASSES + ["custom"], samples_per_class=4, seed=7, hard=True)
    files = sorted(os.path.relpath(p, a) for p in glob.glob(f"{a}/**/*.wav",
                                                             recursive=True))
    assert len(files) == 16
    assert files == sorted(os.path.relpath(p, b) for p in glob.glob(
        f"{b}/**/*.wav", recursive=True))
    for rel in files:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_common_helpers_match_jax(tmp_path):
    path = tmp_path / "classes.txt"
    path.write_text("background\n left\n\nright \n")
    assert common.get_classes(str(path)) == jax_common.get_classes(str(path))
    with pytest.raises(ValueError, match="background"):
        common.ensure_background_first(["left", "background"])
    common.ensure_background_first(["background"])
    assert common.path_names(["a", 3]) == jax_common.path_names(["a", 3])


def test_get_dataset_matches_jax(corpus):
    """Labels, order and val split equal; features within the frontend
    bound.  Neither side writes a cache (use_cache=False)."""
    kw = {"val_split": 0.2, "use_cache": False, "seed": 4, "batch_size": 4}
    jtrain, jval = jax_dataset.get_dataset(corpus, CLASSES,
                                           frontend=JaxFrontend(), **kw)
    train, val = dataset.get_dataset(
        corpus, CLASSES, frontend=MfccFrontend(None, "mfcc", "cpu"), **kw)
    for got, want in ((train, jtrain), (val, jval)):
        np.testing.assert_array_equal(got.y, want.y)
        assert got.x.shape == want.x.shape and got.x.dtype == np.float32
        np.testing.assert_allclose(got.x, want.x, rtol=RTOL, atol=ATOL)
    assert len(val) == 3 and len(train) == 12
    assert not os.path.exists(os.path.join(corpus, "features"))
    audio = dataset.get_audio_dataset(corpus, CLASSES)
    jaudio = jax_dataset.get_audio_dataset(corpus, CLASSES)
    np.testing.assert_array_equal(audio.x, jaudio.x)
    np.testing.assert_array_equal(audio.y, jaudio.y)
    assert list(audio.y) == [0] * 5 + [1] * 5 + [2] * 5


def test_feature_cache_and_pack(tmp_path):
    """The per-sample cache round-trips (reference layout); a pack the JAX
    package wrote is not read, nor is the port's after the params change."""
    root = str(tmp_path / "ds")
    make_synthetic_dataset(root, CLASSES, samples_per_class=2, seed=2)
    fe = MfccFrontend(None, "mfcc", "cpu")
    first = dataset.get_dataset(root, CLASSES, frontend=fe)
    assert len(glob.glob(os.path.join(root, "features", "*", "*.npy"))) == 6
    cached = dataset.get_dataset(root, CLASSES, frontend=None, device="cuda")
    np.testing.assert_array_equal(np.sort(cached.x, 0), np.sort(first.x, 0))
    jax_dataset.pack_cache(root, CLASSES)
    assert dataset._load_packed(root, CLASSES) is None
    dataset.pack_cache(root, CLASSES)
    packed = dataset._load_packed(root, CLASSES)
    np.testing.assert_array_equal(packed.x, cached.x)
    assert jax_dataset._load_packed(root, CLASSES) is None
    assert dataset._load_packed(root, CLASSES, pr.replace(n_mfcc=13)) is None


def test_batch_iterator_matches_jax():
    rng = np.random.default_rng(0)
    ds = dataset.Dataset(rng.standard_normal((11, 3)).astype(np.float32),
                         np.arange(11, dtype=np.int32))
    jds = jax_dataset.Dataset(ds.x, ds.y)
    for kw in ({"shuffle": True, "seed": 3}, {"shuffle": False},
               {"drop_remainder": True}):
        got = list(dataset.batch_iterator(ds, 4, **kw))
        want = list(jax_dataset.batch_iterator(jds, 4, **kw))
        assert len(got) == len(want)
        for (x, y, v), (jx, jy, jv) in zip(got, want):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
            assert v == jv


def test_extract_features_goes_through_the_frontend(corpus):
    """Batches of any size; the frontend's output in f32 on the host."""
    paths = dataset.get_sample_list(corpus, CLASSES)["left"]
    fe = MfccFrontend(None, "mfcc", "cpu", out_dtype=torch.bfloat16)
    feats = dataset.extract_features_batched(paths, fe, batch_size=2)
    assert feats.shape == (5, 30, 20) and feats.dtype == np.float32
    audio = torch.from_numpy(dataset.load_audio_batch(paths))
    np.testing.assert_array_equal(feats, fe(audio).float().numpy())
