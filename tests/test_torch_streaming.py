"""The port's streaming layer (`tpu_speech_commands_torch/streaming/`,
`listen`, `stream_server`, `dev/bench_streaming`) against the JAX package's,
on the CPU, on the same inputs made from a numpy seed.

Tolerances:
- frame features, port against the jitted JAX update: rtol 1e-4 / atol
  1e-5.  Both compute the same f32 DFT, filterbank, log and DCT products in
  another summation order (a scratch run of both `features_from_frames` on
  40 frames differed by at most 1.5e-6); the audio ring and `fill` are
  integer and copy arithmetic, so they are held bit-equal;
- against the JAX package's `NumpyStreamReplica` (float64, sonopy's
  framing): rtol 1e-3 / atol 2e-3, the bound tests/test_streaming.py holds
  the JAX streamer to;
- batched against single-stream runs of the port: rtol 1e-5 / atol 1e-5,
  as tests/test_streaming.py holds the JAX batched update;
- Listener scores, port against JAX: rtol 1e-4 / atol 1e-5, the f32 bound
  of tests/test_torch_serving.py, with equal argmax indices and equal
  trigger events.

The stream tick on the card: tests/test_torch_gpu.py.
"""
import contextlib
import io
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech_commands.frontend import Frontend as JaxFrontend
from tpu_speech_commands.params import ListenerParams as JaxParams
from tpu_speech_commands.streaming import Listener as JaxListener
from tpu_speech_commands.streaming import NumpyStreamReplica
from tpu_speech_commands.streaming import ThresholdDecoder as JaxDecoder
from tpu_speech_commands.streaming import TriggerDetector as JaxTrigger
from tpu_speech_commands.streaming import TriggerDetectorArray as JaxTriggerArray
from tpu_speech_commands.streaming import init_stream_state as jax_init
from tpu_speech_commands.streaming import make_stream_update as jax_update
from tpu_speech_commands.streaming import reset_streams as jax_reset
from tpu_speech_commands_torch import listen, stream_server
from tpu_speech_commands_torch.checkpoints import load_checkpoint
from tpu_speech_commands_torch.dev import bench_streaming
from tpu_speech_commands_torch.export.onnx_writer import export_onnx_model
from tpu_speech_commands_torch.frontend.dsp import Frontend
from tpu_speech_commands_torch.params import ListenerParams, pr
from tpu_speech_commands_torch.training.checkpoints import flatten_variables
from tpu_speech_commands_torch.streaming import (Listener, StreamConfig,
                                                 ThresholdDecoder,
                                                 TriggerDetector,
                                                 TriggerDetectorArray,
                                                 init_stream_state,
                                                 make_stream_update,
                                                 reset_streams)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES_PATH = os.path.join(REPO, "configs", "direction_classes.txt")
CKPTS = {m: os.path.join(REPO, "pretrained", f"direction_{m}.npz")
         for m in ("simple_cnn", "simple_cnn_lite", "simple_gru",
                   "simple_lstm")}
RTOL, ATOL = 1e-4, 1e-5
ALT = {"window_t": 0.016, "hop_t": 0.008, "n_fft": 256}


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """Checkpoint loads write the port's own `pr`, which tests/conftest.py
    does not restore: snapshot and restore it here."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _audio(n: int, seed: int, sample_rate: int = 16000) -> np.ndarray:
    """A 700 Hz tone in noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sample_rate
    return (0.3 * np.sin(2 * np.pi * 700 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _pcm(name: str) -> np.ndarray:
    with wave.open(os.path.join(REPO, "example", name), "rb") as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), "<i2")


def _write_wav(path, pcm: np.ndarray) -> str:
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(pcm.astype("<i2").tobytes())
    return str(path)


def _chunks(pcm: np.ndarray, chunk_size: int = 1024):
    """The chunks run_wav feeds: bytes, the tail zero-padded."""
    n = -(-len(pcm) // chunk_size) * chunk_size
    padded = np.pad(pcm, (0, n - len(pcm)))
    return [padded[i:i + chunk_size].tobytes() for i in range(0, n, chunk_size)]


def _check_state(port_state, jax_state, what):
    np.testing.assert_array_equal(port_state["audio"].numpy(),
                                  np.asarray(jax_state["audio"]),
                                  err_msg=f"{what}: audio ring")
    np.testing.assert_array_equal(port_state["fill"].numpy(),
                                  np.asarray(jax_state["fill"]),
                                  err_msg=f"{what}: fill")
    assert port_state["fill"].dtype == torch.int32


# -- the incremental feature streamer ----------------------------------------

UPDATE_CASES = {
    "default-1024": ({}, 1024),
    "default-512": ({}, 512),
    "default-800": ({}, 800),
    "alt-512": (ALT, 512),
    "use_delta-1024": ({"use_delta": True}, 1024),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    """Chunk for chunk: features within the stated bound of the jitted JAX
    update, the ring and fill bit-equal, and (without deltas) within the
    JAX streamer's bound of the float64 replica."""
    kw, chunk_size = UPDATE_CASES[case]
    p, jp = ListenerParams(**kw), JaxParams(**kw)
    update = make_stream_update(Frontend(p, device="cpu"), chunk_size)
    j_update = jax.jit(jax_update(JaxFrontend(jp), chunk_size))
    state, j_state = init_stream_state(p, device="cpu"), jax_init(jp)
    replica = None if p.use_delta else NumpyStreamReplica(jp)
    audio = _audio(int(p.sample_rate * 1.6), seed=3)
    for c in range(len(audio) // chunk_size):
        chunk = audio[c * chunk_size:(c + 1) * chunk_size]
        state, feats = update(state, torch.from_numpy(chunk))
        j_state, j_feats = j_update(j_state, jnp.asarray(chunk))
        assert feats.shape == (p.n_features, p.feature_size)
        assert state["feats"].shape == (p.n_features, p.n_mfcc)
        np.testing.assert_allclose(feats.numpy(), np.asarray(j_feats),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} chunk {c}")
        _check_state(state, j_state, f"{case} chunk {c}")
        if replica is not None:
            np.testing.assert_allclose(
                feats.numpy(), replica.update(chunk.astype(np.float64)),
                rtol=1e-3, atol=2e-3, err_msg=f"{case} chunk {c} (replica)")


def test_batched_staggered_joins_and_reset_match_single_streams_and_jax():
    """Three slots joining at chunks 0, 2 and 5 (reset_streams on joining),
    slot 0 reset again at chunk 7, chunk 800 (so fills differ between
    slots): each slot equals a fresh single stream from its own start, and
    the batched state equals JAX's batched update."""
    p, jp = ListenerParams(), JaxParams()
    chunk_size = 800
    update = make_stream_update(Frontend(p, device="cpu"), chunk_size)
    j_update = jax.jit(jax_update(JaxFrontend(jp), chunk_size))
    audios = [_audio(9600, seed=11 + s) for s in range(3)]
    joins = {0: (0, 7), 1: (2,), 2: (5,)}  # chunks at which a slot (re)starts
    starts = [None] * 3
    batched = init_stream_state(p, n_streams=3, device="cpu")
    j_batched = jax_init(jp, n_streams=3)
    assert batched["fill"].shape == (3,)
    singles = [None] * 3
    for c in range(10):
        joining = np.array([c in joins[s] for s in range(3)])
        if joining.any():
            batched = reset_streams(batched, joining)
            j_batched = jax_reset(j_batched, jnp.asarray(joining))
            for s in np.nonzero(joining)[0]:
                starts[s] = c
                singles[s] = init_stream_state(p, device="cpu")
        chunk_batch = np.zeros((3, chunk_size), np.float32)
        for s in range(3):
            if starts[s] is not None:
                local = c - starts[s]
                chunk_batch[s] = audios[s][local * chunk_size:
                                           (local + 1) * chunk_size]
        batched, feats = update(batched, torch.from_numpy(chunk_batch))
        j_batched, j_feats = j_update(j_batched, jnp.asarray(chunk_batch))
        np.testing.assert_allclose(feats.numpy(), np.asarray(j_feats),
                                   rtol=RTOL, atol=ATOL, err_msg=f"chunk {c}")
        _check_state(batched, j_batched, f"batched chunk {c}")
        for s in range(3):
            if starts[s] is not None:
                singles[s], s_feats = update(
                    singles[s], torch.from_numpy(chunk_batch[s]))
                np.testing.assert_allclose(
                    feats[s].numpy(), s_feats.numpy(), rtol=1e-5, atol=1e-5,
                    err_msg=f"slot {s} chunk {c}")
                np.testing.assert_array_equal(batched["fill"][s].numpy(),
                                              singles[s]["fill"].numpy())
    assert len(set(batched["fill"].tolist())) > 1  # the fills diverged


def test_value_errors_match_jax():
    """A chunk too large for the feature buffer, then for the audio
    buffer: the JAX package's two ValueErrors, in its order; and the
    port's own refusals of a wrong chunk length or dtype."""
    p, jp = ListenerParams(), JaxParams()
    fe, j_fe = Frontend(p, device="cpu"), JaxFrontend(jp)
    assert StreamConfig(16000, p).max_new > p.n_features
    for chunk_size, match in ((16000, "incremental update"),
                              (15000, "audio buffer")):
        with pytest.raises(ValueError, match=match):
            make_stream_update(fe, chunk_size)
        with pytest.raises(ValueError, match=match):
            jax_update(j_fe, chunk_size)
    update = make_stream_update(fe, 1024)
    state = init_stream_state(p, device="cpu")
    with pytest.raises(ValueError, match="takes 1024"):
        update(state, torch.zeros(512))
    with pytest.raises(TypeError, match="float32"):
        update(state, torch.zeros(1024, dtype=torch.int16))
    with pytest.raises(ValueError, match="batched"):
        reset_streams(state, [True])


def test_state_lives_on_the_requested_device():
    """Without CUDA a state or a Listener built for the card raises: no
    fallback to the CPU."""
    state = init_stream_state(ListenerParams(), 2, device="cpu")
    assert state["fill"].dtype == torch.int32 and state["fill"].shape == (2,)
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_stream_state(ListenerParams(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Listener(model_path=CKPTS["simple_gru"], classes_path=CLASSES_PATH)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_server.main(["--model_path", CKPTS["simple_gru"],
                            "--classes_path", CLASSES_PATH, "--wavs", "x.wav"])


# -- decoder and trigger ------------------------------------------------------

@pytest.mark.parametrize("cfg,center", [(((6, 4),), 0.2),
                                        (((6, 4), (2, 1)), 0.5),
                                        (((3, 0),), 0.2)])
def test_decoder_matches_jax(cfg, center):
    rng = np.random.default_rng(7)
    raw = np.concatenate([[0.0, 1.0, 1e-12, 1 - 1e-12, -0.5, 1.5],
                          rng.uniform(0, 1, 500)])
    dec, j_dec = ThresholdDecoder(cfg, center), JaxDecoder(cfg, center)
    assert [dec.decode(float(v)) for v in raw] == \
        [j_dec.decode(float(v)) for v in raw]
    np.testing.assert_array_equal(dec.decode_array(raw),
                                  j_dec.decode_array(raw))
    for t in (0.1, 0.3, 0.7):
        assert dec.encode(t) == j_dec.encode(t)


def test_triggers_match_jax():
    """Scalar and array detectors over random sticky streams, with
    inactive slots and resets: the same firings and states as JAX's."""
    classes = ["background", "left", "right"]
    rng = np.random.default_rng(17)
    n_slots = 16
    port = [TriggerDetector(1024, classes, 0.5, 3) for _ in range(n_slots)]
    jax_ = [JaxTrigger(1024, classes, 0.5, 3) for _ in range(n_slots)]
    arr = TriggerDetectorArray(1024, classes, 0.5, 3, n_slots=n_slots)
    j_arr = JaxTriggerArray(1024, classes, 0.5, 3, n_slots=n_slots)
    prev = rng.integers(0, 3, n_slots)
    for t in range(300):
        idx = np.where(rng.random(n_slots) < 0.7, prev,
                       rng.integers(0, 3, n_slots))
        prev = idx
        score = rng.random(n_slots)
        active = rng.random(n_slots) < 0.9
        got = [port[i].update(int(idx[i]), float(score[i]))
               for i in range(n_slots)]
        want = [jax_[i].update(int(idx[i]), float(score[i]))
                for i in range(n_slots)]
        assert got == want
        np.testing.assert_array_equal(arr.update(idx, score, active),
                                      j_arr.update(idx, score, active))
        if t % 37 == 0:
            arr.reset(t % n_slots)
            j_arr.reset(t % n_slots)
    np.testing.assert_array_equal(arr.activation, j_arr.activation)
    np.testing.assert_array_equal(arr.record_index, j_arr.record_index)


# -- the Listener ------------------------------------------------------------

def _listen(listener, chunks):
    """Per-chunk scores and argmax, and the trigger events (chunk, index),
    through process_chunk and handle_scores (the bars are swallowed)."""
    listener.reset_stream()
    scores, events = [], []
    with contextlib.redirect_stdout(io.StringIO()):
        for c, data in enumerate(chunks):
            s = np.asarray(listener.process_chunk(data))
            listener.handle_scores(s, on_activation=lambda i, c=c:
                                   events.append((c, i)))
            scores.append(s)
    return np.stack(scores), events


@pytest.mark.parametrize("model_type", sorted(CKPTS))
def test_listener_matches_jax(model_type):
    """One wav of two example clips, chunk by chunk, through the port's
    Listener on the CPU and the JAX Listener: scores within the f32
    bound, equal argmax and equal trigger events (each clip fires)."""
    chunks = _chunks(np.concatenate([_pcm("right_1.wav"), _pcm("up_2.wav")]))
    got, events = _listen(Listener(model_path=CKPTS[model_type],
                                   classes_path=CLASSES_PATH, device="cpu"),
                          chunks)
    want, j_events = _listen(JaxListener(model_path=CKPTS[model_type],
                                         classes_path=CLASSES_PATH), chunks)
    assert got.shape == (len(chunks), 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert events == j_events
    assert [i for _, i in events] == [2, 3]  # right, then up


def test_listener_run_wav_twice_prints_the_same(tmp_path, capsys):
    """Each run_wav is its own session: one bar per chunk (the tail
    zero-padded), the same output twice; an activation saves the ring."""
    pcm = np.concatenate([_pcm("right_1.wav"), _pcm("down_2.wav")[:9000]])
    wav = _write_wav(tmp_path / "in.wav", pcm)
    listener = Listener(model_path=CKPTS["simple_cnn_lite"],
                        classes_path=CLASSES_PATH, input_wav=wav,
                        save_dir=str(tmp_path / "saved"), device="cpu")
    assert listener.classifier_path == "torch"
    listener.run_wav()
    out = capsys.readouterr().out
    bars = [line for line in out.splitlines() if "detected" not in line
            and not line.startswith("Saved")]
    assert len(bars) == -(-len(pcm) // 1024)
    assert "command right detected!" in out
    assert os.listdir(tmp_path / "saved" / "right")
    listener.save_dir = None
    listener.run_wav()
    again = capsys.readouterr().out
    assert [ln for ln in again.splitlines()] == \
        [ln for ln in out.splitlines() if not ln.startswith("Saved")]


def test_listener_int16_chunk_matches_bytes():
    """int16 arrays decode like bytes (/32768) before the ring."""
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal(3072) * 4000).astype(np.int16)
    a = Listener(model_path=CKPTS["simple_gru"], classes_path=CLASSES_PATH,
                 device="cpu")
    b = Listener(model_path=CKPTS["simple_gru"], classes_path=CLASSES_PATH,
                 device="cpu")
    for lo in range(0, 3072, 1024):
        s_bytes = a.process_chunk(pcm[lo:lo + 1024].tobytes())
        s_int16 = b.process_chunk(pcm[lo:lo + 1024])
        np.testing.assert_array_equal(s_int16, s_bytes)


def test_listener_refuses_external_formats_and_snapshots_params(tmp_path):
    """An exported `.onnx` loads: the Listener on it scores each chunk as
    the native Listener does (rtol 1e-4 / atol 1e-5).  An unknown suffix
    is refused (ValueError), and so is a typo'd argument; a Listener's
    params are a snapshot."""
    onnx = export_onnx_model(CKPTS["simple_gru"], str(tmp_path / "gru.onnx"))
    chunks = _chunks(_pcm("right_1.wav"))
    want, want_events = _listen(Listener(model_path=CKPTS["simple_gru"],
                                         classes_path=CLASSES_PATH,
                                         device="cpu"), chunks)
    external = Listener(model_path=onnx, classes_path=CLASSES_PATH,
                        device="cpu")
    assert external.model_format == "ONNX"
    got, got_events = _listen(external, chunks)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got_events == want_events
    with pytest.raises(ValueError, match="invalid model file"):
        Listener(model_path=str(tmp_path / "m.bin"),
                 classes_path=CLASSES_PATH, device="cpu")
    with pytest.raises(TypeError, match="sensitivty"):
        Listener(model_path=CKPTS["simple_gru"], classes_path=CLASSES_PATH,
                 sensitivty=0.4, device="cpu")
    listener = Listener(model_path=CKPTS["simple_gru"],
                        classes_path=CLASSES_PATH, device="cpu")
    snap = listener.pr.to_dict()
    pr.override({"n_fft": 256})
    assert listener.pr.to_dict() == snap


# -- the entry points --------------------------------------------------------

def test_listen_dump_model_round_trip(tmp_path, capsys):
    """--dump_model re-saves the checkpoint (.npz appended); the copy has
    the same tensors and meta, and a Listener on it scores the same."""
    with pytest.raises(SystemExit):
        listen.main(["--model_path", CKPTS["simple_lstm"], "--classes_path",
                     CLASSES_PATH, "--dump_model", "--output_model_file",
                     str(tmp_path / "copy"), "--device", "cpu"])
    assert "writing" in capsys.readouterr().out
    (v, meta), (v2, meta2) = (load_checkpoint(CKPTS["simple_lstm"]),
                              load_checkpoint(str(tmp_path / "copy.npz")))
    assert meta == meta2
    flat, flat2 = flatten_variables(v), flatten_variables(v2)
    assert sorted(flat) == sorted(flat2) and flat
    for key, leaf in flat.items():
        np.testing.assert_array_equal(leaf, flat2[key])
    with pytest.raises(ValueError, match="output model file"):
        listen.dump_model(CKPTS["simple_lstm"], None)
    chunks = _chunks(_pcm("down_1.wav"))
    want, _ = _listen(Listener(model_path=CKPTS["simple_lstm"],
                               classes_path=CLASSES_PATH, device="cpu"),
                      chunks)
    got, _ = _listen(Listener(model_path=str(tmp_path / "copy.npz"),
                              classes_path=CLASSES_PATH, device="cpu"),
                     chunks)
    np.testing.assert_array_equal(got, want)


def test_listen_main_replays_a_wav(capsys):
    listener = listen.main([
        "--model_path", CKPTS["simple_gru"], "--classes_path", CLASSES_PATH,
        "--input_wav", os.path.join(REPO, "example", "left_2.wav"),
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\n") == 16 + 1  # 16 bars (15.6 chunks), one event
    assert "command left detected!" in out
    assert listener.device == torch.device("cpu")


def test_stream_server_matches_single_stream_listeners(capsys):
    """Three clips into 2 slots with staggered admission and a slot reused:
    each stream's trigger events (its own chunk index, the command) equal a
    single-stream Listener's on the same clip."""
    names = ["left_1.wav", "right_2.wav", "down_1.wav"]
    events = stream_server.main([
        "--model_path", CKPTS["simple_gru"], "--classes_path", CLASSES_PATH,
        "--wavs", *(os.path.join(REPO, "example", n) for n in names),
        "--slots", "2", "--stagger", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 streams" in out and "slot 0 <- down_1.wav" in out
    listener = Listener(model_path=CKPTS["simple_gru"],
                        classes_path=CLASSES_PATH, device="cpu")
    classes = listener.class_names
    for name in names:
        _, want = _listen(listener, _chunks(_pcm(name)))
        got = [(e["chunk"], e["command"]) for e in events if e["wav"] == name]
        assert got == [(c, classes[i]) for c, i in want], name
        assert len(got) == 1 and got[0][1] == name.split("_")[0]


def test_bench_streaming_runs_on_the_cpu():
    result = bench_streaming.main(["--model_type", "simple_cnn_lite",
                                   "--streams", "3", "--iters", "5",
                                   "--device", "cpu"])
    assert result["classifier"] == "torch" and result["streams"] == 3
    assert 0 < result["p50_ms"] <= result["p99_ms"]
    assert result["budget_ms"] == 64.0


def test_listener_chime_from_the_repo_root_and_no_microphone(monkeypatch):
    """play_activate_audio plays assets/activate.wav (resolved from the
    repository root) or chime_path through PyAudio; without PyAudio the
    microphone loop raises ImportError."""
    import sys
    import types

    played = []

    class _Stream:
        def write(self, data):
            played.append(len(data))

        def stop_stream(self):
            pass

        def close(self):
            pass

    class _PyAudio:
        def open(self, **kwargs):
            played.append(("rate", kwargs["rate"]))
            return _Stream()

        def get_format_from_width(self, width):
            return width

        def terminate(self):
            pass

    fake = types.ModuleType("pyaudio")
    fake.PyAudio = _PyAudio
    monkeypatch.setitem(sys.modules, "pyaudio", fake)
    listener = Listener.__new__(Listener)  # no model needed for the chime
    for chime in (None, os.path.join(REPO, "assets", "wozai.wav")):
        played.clear()
        listener.chime_path = chime
        listener.play_activate_audio()
        assert played[0] == ("rate", 16000) and len(played) > 1
    monkeypatch.setitem(sys.modules, "pyaudio", None)
    with pytest.raises(ImportError, match="PyAudio"):
        listener.run_microphone()
