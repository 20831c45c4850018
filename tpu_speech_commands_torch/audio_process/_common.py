"""Shared helpers of the audio tools (counterpart of
`tools/audio_process/_common.py`): the port's wav codec, and the walk over
an input path."""
from __future__ import annotations

import os
from glob import glob

from ..data.wav import load_wav, save_audio, wav_duration_samples  # noqa: F401


def iter_wavs(path: str):
    """Yield wav paths from a file or directory."""
    if os.path.isdir(path):
        yield from sorted(glob(os.path.join(path, "**", "*.wav"), recursive=True))
    else:
        yield path


def out_path(output_dir: str, src_path: str, input_root: str | None = None) -> str:
    """Destination path for a processed wav.

    When input_root is a directory containing src_path, the relative
    subpath is preserved — a recursively-globbed corpus (class/name.wav
    trees) would otherwise collapse to basenames and silently overwrite
    same-named files from different classes."""
    rel = os.path.basename(src_path)
    if input_root and os.path.isdir(input_root):
        try:
            cand = os.path.relpath(os.path.abspath(src_path),
                                   os.path.abspath(input_root))
            if not cand.startswith(".."):
                rel = cand
        except ValueError:  # different drive (windows)
            pass
    dst = os.path.join(output_dir, rel)
    os.makedirs(os.path.dirname(dst) or output_dir, exist_ok=True)
    return dst
