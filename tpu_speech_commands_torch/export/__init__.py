from .inference_loader import (NativePredictor, load_inference_model,
                               load_native, resolve_checkpoint_contract,
                               resolve_feature_type)

__all__ = ["NativePredictor", "load_inference_model", "load_native",
           "resolve_checkpoint_contract", "resolve_feature_type"]
