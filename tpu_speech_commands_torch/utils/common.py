"""Miscellaneous utilities (counterpart of
`tpu_speech_commands/utils/common.py`, a copy)."""
from __future__ import annotations


def get_classes(classes_path: str) -> list[str]:
    """Load class names, one per line."""
    with open(classes_path) as f:
        class_names = [c.strip() for c in f.readlines()]
    return [c for c in class_names if c]


def path_names(path) -> list[str]:
    """String names for a key path (DictKey.key / GetAttrKey.name /
    SequenceKey.idx, or plain strings)."""
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
        else:
            out.append(str(k))
    return out


def ensure_background_first(class_names: list[str]) -> None:
    """Every entry point requires the first class to be 'background'.
    ValueError, not assert: user CLI input must still be rejected under
    python -O."""
    if not class_names or class_names[0] != "background":
        raise ValueError("1st class should be background.")
