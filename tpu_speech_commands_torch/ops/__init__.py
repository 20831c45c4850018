"""Hand-written CUDA kernels of the port and their wrappers.  Nothing here
builds or imports a compiler at import time: `_build.load_library` runs at
the first launch."""
from .frontend_kernel import MfccFrontend, mfcc_frontend_cuda
from .rnn_kernel import GRUClassifier, gru_layer_cuda

__all__ = ["MfccFrontend", "mfcc_frontend_cuda", "GRUClassifier",
           "gru_layer_cuda"]
