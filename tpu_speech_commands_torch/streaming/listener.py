"""Streaming keyword-spotting runtime (counterpart of
`tpu_speech_commands/streaming/listener.py`; reference: listen.py:31-448).

`Listener` ties together: params injection, the class list, multi-format
model loading (`export.inference_loader.load_inference_model`), the
incremental feature streamer, ThresholdDecoder calibration and
TriggerDetector debouncing.

Each chunk runs one tick on the Listener's device (the card unless the
caller passes device="cpu"): the ring update and the chunk's frame
features (`streaming/feature_stream.py`).  For a native `.npz` model the
same tick then runs the classifier through `serving.make_classifier` in
float32, as the JAX Listener runs its model: on the card the GRU, LSTM or
CNN classifier kernel, on the CPU the plain module; then the softmax.  A
tick moves the chunk to the device and the (C,) scores back.  An exported
model (`.tscm`, onnx, tflite, h5, SavedModel, pb) runs on the host: the
tick moves the (n_features, n_mfcc) features back and its runtime scores
them (`update_vectors` returns those features).

Modes: `run_wav` (deterministic wav replay, testable), `run_microphone`
(PyAudio, gated on availability).
"""
from __future__ import annotations

import os
import shutil
import wave
from random import randint

import numpy as np
import torch

from ..data.wav import buffer_to_audio, save_audio
from ..device import DEFAULT_DEVICE, resolve_device
from ..export.inference_loader import (load_inference_model,
                                       resolve_checkpoint_contract)
from ..frontend.dsp import Frontend
from ..params import inject_params, pr
from ..serving import make_classifier
from ..utils import ensure_background_first, get_classes
from .decoder import ThresholdDecoder
from .feature_stream import (init_stream_state, make_stream_step,
                             make_stream_update)
from .trigger import TriggerDetector

default_config = {
    "model_path": "",
    "classes_path": os.path.join("configs", "direction_classes.txt"),
    "params_path": None,
    "chunk_size": 1024,
    "sensitivity": 0.5,
    "trigger_level": 3,
    "save_dir": None,
    "input_wav": None,
    # None = take the checkpoint's stored feature_type (mfcc fallback)
    "feature_type": None,
    # activation chime wav; None = assets/activate.wav (assets/wozai.wav
    # is the shipped alternative, mirroring the reference's asset pair)
    "chime_path": None,
    # the card unless the caller asks for "cpu"
    "device": DEFAULT_DEVICE,
}


class Listener:
    _defaults = default_config

    def __init__(self, **kwargs):
        unknown = set(kwargs) - set(self._defaults)
        if unknown:
            # a typo'd kwarg (e.g. sensitivty=) would otherwise become a
            # dead attribute while the real knob keeps its default
            raise TypeError(f"unknown Listener arguments: {sorted(unknown)}")
        self.__dict__.update(self._defaults)
        self.__dict__.update(kwargs)
        self.device = resolve_device(self.device)

        self.class_names = get_classes(self.classes_path)
        ensure_background_first(self.class_names)

        # load FIRST: a native checkpoint restores its stored train-time
        # params into pr, then an explicit --params_path wins on top —
        # otherwise user decoder/threshold recalibration would be silently
        # clobbered by the checkpoint
        self.predictor, self.model_format = load_inference_model(
            self.model_path, self.device)
        if self.params_path:
            inject_params(self.params_path)
        # SNAPSHOT the params: a live alias to the mutable global would be
        # rewired in place by any later checkpoint load
        self.pr = pr.replace()
        self.feature_type = resolve_checkpoint_contract(
            self.predictor, self.model_format, class_names=self.class_names,
            feature_type=self.feature_type)

        self.threshold_decoder = ThresholdDecoder(
            self.pr.threshold_config, self.pr.threshold_center
        )
        self.detector = TriggerDetector(
            self.chunk_size, self.class_names, self.sensitivity, self.trigger_level
        )

        self.frontend = Frontend(self.pr, feature_type=self.feature_type,
                                 device=self.device)
        self._setup_stream()
        self.session_id = "%09d" % randint(0, 999999999)
        self.record_num = 0

    # -- streaming state -----------------------------------------------------

    def _setup_stream(self):
        update = make_stream_update(self.frontend, self.chunk_size)
        self.state = init_stream_state(self.pr, device=self.device)
        if self.model_format == "NATIVE":
            # float32, as the JAX Listener runs its model; the wrapper
            # packs the weights once
            self.classifier, self.classifier_path = make_classifier(
                self.predictor.model, self.predictor.model_type)
            self._step = make_stream_step(update, self.classifier,
                                          self.predictor.model_type)
            self._external = None
        else:
            # the update alone on the device; the host runtime scores
            self._step = update
            self._external = self.predictor

    def update_vectors(self, chunk: bytes | np.ndarray) -> np.ndarray:
        """Feed one chunk of audio; returns the (n_features, n_mfcc, 1)
        feature tensor (the reference's update_vectors contract).  Only for
        an external-format model; a native one runs the fused chunk ->
        scores tick (process_chunk)."""
        assert self._external is not None, (
            "update_vectors is only meaningful for external-format models; "
            "native models run the fused chunk->scores step (process_chunk)"
        )
        audio = torch.from_numpy(self._decode_chunk(chunk)).to(self.device)
        self.state, feats = self._step(self.state, audio)
        return feats.cpu().numpy()[..., None]

    @staticmethod
    def _decode_chunk(chunk: bytes | np.ndarray) -> np.ndarray:
        """bytes or ndarray chunk -> float32 audio in [-1, 1).

        int16 ndarrays get the same /32768 PCM decode as bytes input —
        without it an int16 array would enter the ring buffer 32768x too
        large and silently produce garbage features."""
        if isinstance(chunk, bytes):
            return buffer_to_audio(chunk)
        chunk = np.asarray(chunk)
        if chunk.dtype == np.int16:
            return chunk.astype(np.float32) / 32768.0
        return chunk.astype(np.float32, copy=False)

    def process_chunk(self, chunk: bytes | np.ndarray) -> np.ndarray:
        """Chunk -> class scores (softmax): one fused tick for a native
        model, the update then the host runtime for an external one."""
        audio = torch.from_numpy(self._decode_chunk(chunk)).to(self.device)
        if self._external is None:
            self.state, scores = self._step(self.state, audio)
            return scores.cpu().numpy()
        self.state, feats = self._step(self.state, audio)
        return self._external(feats.cpu().numpy()[None])[0]

    # -- postprocess / UI ----------------------------------------------------

    def handle_scores(self, scores: np.ndarray, on_activation=None):
        """argmax -> threshold decode (non-background) -> bar -> trigger."""
        index = int(np.argmax(scores))
        score = float(scores[index])
        if self.class_names[index] != "background":
            score = self.threshold_decoder.decode(score)
        self.on_prediction(index, score)
        if self.detector.update(index, score):
            # the activation chime only plays in live-mic mode (listen.py:361)
            self.on_activation(index, play_activate=getattr(self, "_mic_mode", False))
            if on_activation:
                on_activation(index)
        return index, score

    def on_prediction(self, index: int, score: float, max_width: int = 80):
        """80-col X/x/- confidence bar (listen.py:274-288)."""
        width = min(shutil.get_terminal_size()[0], max_width)
        class_name = self.class_names[index]
        if class_name == "background":
            score = 1.0 - score
            class_name = ""
        units = int(round(score * width))
        bar = "X" * units + "-" * (width - units)
        cutoff = round(self.sensitivity * width)
        print(bar[:cutoff] + bar[cutoff:].replace("X", "x") + class_name)

    def on_activation(self, index: int, play_activate: bool = False):
        print("command {} detected!".format(self.class_names[index]))
        if play_activate:
            self.play_activate_audio()
        if self.save_dir:
            save_class_dir = os.path.join(self.save_dir, self.class_names[index])
            os.makedirs(save_class_dir, exist_ok=True)
            wav_path = os.path.join(
                save_class_dir, f"{self.session_id}_{self.record_num}.wav"
            )
            save_audio(wav_path, self.state["audio"].cpu().numpy())
            print("Saved to " + wav_path + ".")
            self.record_num += 1

    def play_activate_audio(self, wav_path: str | None = None):
        """Play the activation chime (mic mode; listen.py:294-297,311-339).
        No-op with a notice when PyAudio is unavailable."""
        wav_path = wav_path or self.chime_path or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "assets", "activate.wav",
        )
        try:
            import pyaudio
        except ImportError:
            print("(PyAudio not installed — skipping activation chime)")
            return
        with wave.open(wav_path, "rb") as wf:
            p = pyaudio.PyAudio()
            stream = p.open(
                format=p.get_format_from_width(wf.getsampwidth()),
                channels=wf.getnchannels(), rate=wf.getframerate(), output=True,
            )
            data = wf.readframes(1024)
            while data:
                stream.write(data)
                data = wf.readframes(1024)
            stream.stop_stream()
            stream.close()
            p.terminate()

    # -- run loops -----------------------------------------------------------

    def reset_stream(self):
        """Fresh stream + trigger state for a new session: without this, a
        second run_wav (or run_wav after mic use) would score its opening
        chunks against the previous session's ring-buffer tail and inherit
        its activation counter (the reference gets a fresh state for free
        by running one process per listen.py invocation)."""
        self.state = init_stream_state(self.pr, device=self.device)
        self.detector.reset()

    def run_wav(self, wav_path: str | None = None, realtime: bool = False):
        """Replay a wav through the streaming loop (listen.py:384-436).

        Each call is an independent session (see reset_stream)."""
        import time

        self.reset_stream()
        wav_path = wav_path or self.input_wav
        with wave.open(wav_path, "rb") as wf:
            # real exceptions, not asserts: wrong-format wavs must be
            # rejected even under python -O
            if wf.getframerate() != self.pr.sample_rate:
                raise ValueError("unmatched sample rate")
            if wf.getsampwidth() != self.pr.sample_depth:
                raise ValueError("unmatched sample depth")
            if wf.getnchannels() != 1:
                raise ValueError("only support mono channel")
            while True:
                data = wf.readframes(self.chunk_size)
                if not data:
                    break
                if len(data) < self.chunk_size * self.pr.sample_depth:
                    # the reference feeds the ragged tail through
                    # update_vectors (listen.py:403); the fixed-shape
                    # streamer needs full chunks, so zero-pad the final
                    # partial chunk instead of dropping the wav tail
                    data = data + b"\x00" * (
                        self.chunk_size * self.pr.sample_depth - len(data)
                    )
                scores = self.process_chunk(data)
                self.handle_scores(scores)
                if realtime:
                    time.sleep(self.chunk_size / self.pr.sample_rate)

    def run_microphone(self):
        """Live microphone loop (listen.py:341-381); requires PyAudio."""
        try:
            import pyaudio
        except ImportError as e:
            raise ImportError(
                "PyAudio is not installed — microphone mode unavailable. "
                "Use run_wav for wav replay."
            ) from e
        p = pyaudio.PyAudio()
        stream = p.open(
            format=pyaudio.paInt16,
            channels=1,
            rate=self.pr.sample_rate,
            input=True,
            frames_per_buffer=self.chunk_size,
        )
        self._mic_mode = True
        try:
            while True:
                data = stream.read(self.chunk_size, exception_on_overflow=False)
                scores = self.process_chunk(data)
                self.handle_scores(scores)
        except KeyboardInterrupt:
            pass
        finally:
            self._mic_mode = False
            stream.stop_stream()
            stream.close()
            p.terminate()

    def run(self):
        if self.input_wav:
            self.run_wav(self.input_wav)
        else:
            self.run_microphone()
