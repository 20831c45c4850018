"""Streaming keyword spotting (counterpart of `tpu_speech_commands/streaming`):
the incremental feature streamer, the Listener, the threshold decoder and
the trigger detectors.  The entry points: `python -m
tpu_speech_commands_torch.listen` (one stream) and `python -m
tpu_speech_commands_torch.stream_server` (a pool of slots)."""
from .decoder import ThresholdDecoder
from .feature_stream import (
    StreamConfig,
    init_stream_state,
    make_stream_step,
    make_stream_update,
    reset_streams,
)
from .listener import Listener, default_config
from .trigger import TriggerDetector, TriggerDetectorArray

__all__ = [
    "ThresholdDecoder",
    "TriggerDetector",
    "TriggerDetectorArray",
    "Listener",
    "default_config",
    "StreamConfig",
    "init_stream_state",
    "make_stream_step",
    "make_stream_update",
    "reset_streams",
]
