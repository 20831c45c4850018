from .dsp import Frontend, add_deltas, decode_audio, frame_signal, safe_log

__all__ = ["Frontend", "add_deltas", "decode_audio", "frame_signal", "safe_log"]
