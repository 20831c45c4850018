from .common import ensure_background_first, get_classes, path_names

__all__ = ["ensure_background_first", "get_classes", "path_names"]
