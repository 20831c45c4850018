"""ctypes binding to the C++ runtime in `native/` (counterpart of
`tpu_speech_commands/native_binding.py`: the same classes over the same C
interface).

Exposes the native DSP frontend, the model runtime over a `.tscm` blob and
the per-chunk streaming engine.  The library is the port's own build,
`utils/native_build.py`: compiled with g++ into `build/native_torch/` at
first use.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .params import pr
from .utils.native_build import ensure_native_library

_lib = None


def lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(ensure_native_library()))
        _lib.tsc_frontend_create.restype = ctypes.c_void_p
        _lib.tsc_frontend_create.argtypes = [ctypes.c_int] * 8
        _lib.tsc_frontend_destroy.argtypes = [ctypes.c_void_p]
        _lib.tsc_frontend_segment.restype = ctypes.c_int
        _lib.tsc_frontend_segment.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib.tsc_frontend_feature_size.restype = ctypes.c_int
        _lib.tsc_frontend_feature_size.argtypes = [ctypes.c_void_p]
        _lib.tsc_model_load.restype = ctypes.c_void_p
        _lib.tsc_model_load.argtypes = [ctypes.c_char_p]
        _lib.tsc_model_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("tsc_model_num_classes", "tsc_model_n_features",
                   "tsc_model_feature_width"):
            getattr(_lib, fn).restype = ctypes.c_int
            getattr(_lib, fn).argtypes = [ctypes.c_void_p]
        _lib.tsc_model_predict.restype = ctypes.c_int
        _lib.tsc_model_predict.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib.tsc_stream_create.restype = ctypes.c_void_p
        _lib.tsc_stream_create.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ]
        _lib.tsc_stream_destroy.argtypes = [ctypes.c_void_p]
        _lib.tsc_stream_step.restype = ctypes.c_int
        _lib.tsc_stream_step.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
    return _lib


class NativeFrontend:
    """Native C++ DSP frontend (the algorithm of the JAX package's
    frontend/numpy_ref.py)."""

    def __init__(self, params=None, feature_type: str = "mfcc"):
        p = params or pr
        self.params = p
        self._fe = lib().tsc_frontend_create(
            p.sample_rate, p.window_samples, p.hop_samples, p.n_fft,
            p.n_filt, p.n_mfcc, int(p.use_delta), int(feature_type == "bark"),
        )
        if not self._fe:
            raise RuntimeError("failed to create native frontend")
        self.feature_size = lib().tsc_frontend_feature_size(self._fe)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """(n,) float audio -> (frames, feature_size) float32."""
        audio = np.ascontiguousarray(audio, np.float32)
        n = len(audio)
        p = self.params
        frames = max(0, 1 + (n - p.window_samples) // p.hop_samples)
        out = np.zeros((frames, self.feature_size), np.float32)
        got = lib().tsc_frontend_segment(
            self._fe,
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        assert got == frames, (got, frames)
        return out

    def __del__(self):
        if getattr(self, "_fe", None):
            try:
                lib().tsc_frontend_destroy(self._fe)
            except Exception:
                pass


class NativeModel:
    """Native C++ model runtime over an exported .tscm blob."""

    def __init__(self, path: str):
        self._m = lib().tsc_model_load(path.encode())
        if not self._m:
            raise RuntimeError(f"failed to load native model: {path}")
        self.num_classes = lib().tsc_model_num_classes(self._m)
        self.n_features = lib().tsc_model_n_features(self._m)
        self.feature_width = lib().tsc_model_feature_width(self._m)

    def predict(self, features: np.ndarray) -> np.ndarray:
        """(n_features, width) -> (num_classes,) softmax scores."""
        feats = np.ascontiguousarray(features, np.float32)
        out = np.zeros(self.num_classes, np.float32)
        got = lib().tsc_model_predict(
            self._m,
            feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            feats.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if got != self.num_classes:
            raise RuntimeError(
                f"native predict failed (rc={got}) — corrupt model or "
                f"wrong feature shape {feats.shape}"
            )
        return out

    def __del__(self):
        if getattr(self, "_m", None):
            try:
                lib().tsc_model_destroy(self._m)
            except Exception:
                pass


class NativeStreamer:
    """The native per-chunk streaming engine (StreamRuntime) over ctypes:
    ring append -> incremental features -> invoke -> ThresholdDecoder ->
    TriggerDetector — the exact pipeline the native stream/ALSA apps run
    (native/stream_runtime.h), drivable from any host process."""

    def __init__(self, model: "NativeModel", chunk_size: int = 1024,
                 sensitivity: float = 0.5, trigger_level: int = 3):
        self._model = model  # keep the model handle alive (C side borrows)
        self.chunk_size = chunk_size
        self._s = lib().tsc_stream_create(
            model._m, chunk_size, sensitivity, trigger_level
        )
        if not self._s:
            raise RuntimeError(
                f"failed to create native stream (chunk_size {chunk_size} "
                f"out of range for this model?)"
            )

    def step(self, chunk: np.ndarray) -> dict:
        """One chunk_size float chunk -> {index, score, background,
        triggered}; score is decoded for commands, raw for background."""
        chunk = np.ascontiguousarray(chunk, np.float32)
        if chunk.size != self.chunk_size:
            raise ValueError(
                f"chunk has {chunk.size} samples, expected {self.chunk_size}"
            )
        idx = ctypes.c_int()
        score = ctypes.c_float()
        bg = ctypes.c_int()
        trig = ctypes.c_int()
        rc = lib().tsc_stream_step(
            self._s, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(idx), ctypes.byref(score), ctypes.byref(bg),
            ctypes.byref(trig),
        )
        if rc != 0:
            raise RuntimeError("native stream step failed")
        return {
            "index": idx.value,
            "score": float(score.value),
            "background": bool(bg.value),
            "triggered": bool(trig.value),
        }

    def __del__(self):
        if getattr(self, "_s", None):
            try:
                lib().tsc_stream_destroy(self._s)
            except Exception:
                pass
