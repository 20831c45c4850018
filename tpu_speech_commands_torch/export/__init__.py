from .inference_loader import (NativePredictor, external_format, load_native,
                               require_native, resolve_feature_type)

__all__ = ["NativePredictor", "external_format", "load_native",
           "require_native", "resolve_feature_type"]
