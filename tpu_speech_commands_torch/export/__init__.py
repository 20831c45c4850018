from .inference_loader import NativePredictor, load_native

__all__ = ["NativePredictor", "load_native"]
