"""Hand-written CUDA kernels of the port and their wrappers.  Nothing here
builds or imports a compiler at import time: `_build.load_library` runs at
the first launch."""
from .cnn_kernel import (
    CNNClassifier,
    cnn_block1_cuda,
    cnn_classifier_cuda,
    make_fused_cnn_forward,
    make_fused_conv_block1,
)
from .dense_dft_kernel import (
    DenseDftConstants,
    dense_dft_combined,
    dense_dft_combined_cuda,
    dense_dft_halves,
    dense_dft_halves_cuda,
)
from .frontend_kernel import (
    MfccFrontend,
    dft_frontend_bf16_cuda,
    mfcc_frontend_cuda,
)
from .load_kernel import (
    load_broadcast,
    load_broadcast_cuda,
    load_rowsum,
    load_rowsum_cuda,
)
from .rnn_kernel import (
    GRUClassifier,
    LSTMClassifier,
    gru_layer_cuda,
    lstm_layer_cuda,
)

__all__ = ["MfccFrontend", "mfcc_frontend_cuda", "dft_frontend_bf16_cuda",
           "GRUClassifier", "gru_layer_cuda", "LSTMClassifier",
           "lstm_layer_cuda", "CNNClassifier", "cnn_classifier_cuda",
           "cnn_block1_cuda", "make_fused_conv_block1",
           "make_fused_cnn_forward", "DenseDftConstants",
           "dense_dft_combined", "dense_dft_combined_cuda",
           "dense_dft_halves", "dense_dft_halves_cuda", "load_rowsum",
           "load_rowsum_cuda", "load_broadcast", "load_broadcast_cuda"]
