"""Audio pipeline parameters (counterpart of `tpu_speech_commands/params.py`).

The port keeps its own copy of `ListenerParams` and its own global `pr`
singleton: it imports nothing of the JAX package.  The two singletons are
distinct objects, so a config injected into one package (`inject_params`, or
a checkpoint load, which applies the checkpoint's stored params) is not seen
by the other.  Within the port every layer imports `pr` by reference and
injection mutates it in place, as in the JAX package.

Derived-quantity rounding matches the reference: ``window_samples`` and
``hop_samples`` round half-up, ``buffer_samples`` truncates to a hop
multiple, ``n_features`` is ``1 + floor((buffer - window) / hop)``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from math import floor

__all__ = ["ListenerParams", "pr", "inject_params", "save_params"]

# Fields stored in params.json (the reference JSON schema's key set)
_STORED_FIELDS = (
    "buffer_t",
    "window_t",
    "hop_t",
    "sample_rate",
    "sample_depth",
    "n_fft",
    "n_filt",
    "n_mfcc",
    "use_delta",
    "threshold_config",
    "threshold_center",
)


@dataclasses.dataclass(frozen=True)
class ListenerParams:
    """Parameters of the audio -> feature -> confidence pipeline.

    - buffer_t: input audio length in seconds (command must fit inside)
    - window_t: STFT window length in seconds
    - hop_t: STFT hop in seconds
    - sample_rate: input audio sample rate (Hz)
    - sample_depth: bytes per input PCM sample (only 2 supported)
    - n_fft: FFT size per frame
    - n_filt: number of mel (or bark) filters
    - n_mfcc: number of cepstral coefficients kept
    - use_delta: append first-order deltas to each frame
    - threshold_config: tuple of (mu, std) logit-normal components for the
      threshold decoder
    - threshold_center: raw network output that should decode to 0.5
    """

    buffer_t: float = 1.0
    window_t: float = 0.064
    hop_t: float = 0.032
    sample_rate: int = 16000
    sample_depth: int = 2
    n_fft: int = 1024
    n_filt: int = 20
    n_mfcc: int = 20
    use_delta: bool = False
    threshold_config: tuple = ((6, 4),)
    threshold_center: float = 0.2

    @property
    def window_samples(self) -> int:
        """window_t converted to samples (round half-up)."""
        return int(self.sample_rate * self.window_t + 0.5)

    @property
    def hop_samples(self) -> int:
        """hop_t converted to samples (round half-up)."""
        return int(self.sample_rate * self.hop_t + 0.5)

    @property
    def buffer_samples(self) -> int:
        """buffer_t in samples, truncated to a whole number of hops."""
        samples = int(self.sample_rate * self.buffer_t + 0.5)
        return self.hop_samples * (samples // self.hop_samples)

    @property
    def n_features(self) -> int:
        """Number of timesteps in one network input."""
        return 1 + int(
            floor((self.buffer_samples - self.window_samples) / self.hop_samples)
        )

    @property
    def max_samples(self) -> int:
        """The input size converted to audio samples (truncating)."""
        return int(self.buffer_t * self.sample_rate)

    @property
    def feature_size(self) -> int:
        """Width of one feature vector (doubled when deltas are appended)."""
        return self.n_mfcc * 2 if self.use_delta else self.n_mfcc

    @property
    def n_fft_bins(self) -> int:
        """Number of rfft output bins."""
        return self.n_fft // 2 + 1

    def to_dict(self) -> dict:
        d = {f: getattr(self, f) for f in _STORED_FIELDS}
        # JSON-friendly threshold_config (list of [mu, std] pairs)
        d["threshold_config"] = [list(p) for p in self.threshold_config]
        return d

    def replace(self, **kwargs) -> "ListenerParams":
        if "threshold_config" in kwargs:
            kwargs["threshold_config"] = tuple(
                tuple(p) for p in kwargs["threshold_config"]
            )
        return dataclasses.replace(self, **kwargs)

    def override(self, mapping: dict) -> None:
        """In-place field update (the global singleton's injection).

        Atomic: every value is converted before the first field is written,
        so a bad entry cannot leave the singleton half-mutated.  Unknown keys
        are skipped with a warning."""
        if not isinstance(mapping, dict):
            raise TypeError(f"params must be a JSON object, got "
                            f"{type(mapping).__name__}")
        staged = {}
        for key, value in mapping.items():
            if key not in _STORED_FIELDS:
                print(f"Warning: ignoring unknown params key {key!r}")
                continue
            if key == "threshold_config":
                value = tuple(tuple(p) for p in value)
            staged[key] = value
        for key, value in staged.items():
            object.__setattr__(self, key, value)


# The port's global listener parameters: modules import this by reference,
# and injection mutates it in place so every layer of the port sees it.
pr = ListenerParams()


def inject_params(params_file: str) -> ListenerParams:
    """Load JSON params into the port's global `pr` (in place).  A file that
    exists but cannot be read as params only prints a warning, as in the
    reference."""
    try:
        with open(params_file) as f:
            pr.override(json.load(f))
    except (OSError, ValueError, TypeError, AttributeError):
        if os.path.isfile(params_file):
            print("Warning: Failed to load parameters from " + params_file)
    return pr


def save_params(params_file: str) -> None:
    """Save the port's global listener params to a JSON file."""
    with open(params_file, "w") as f:
        json.dump(pr.to_dict(), f, indent=2)
