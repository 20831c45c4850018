from .factory import (
    CNN_MODEL_TYPES,
    MODEL_TYPES,
    features_to_input,
    get_model,
    init_model,
    input_shape,
    is_cnn,
    score_fn,
)
from .cnn import SimpleCNN, SimpleCNNLite
from .rnn import GRUCellKeras, LSTMCellKeras, SimpleGRU, SimpleLSTM

__all__ = [
    "CNN_MODEL_TYPES", "MODEL_TYPES", "features_to_input", "get_model",
    "init_model", "input_shape", "is_cnn", "score_fn", "GRUCellKeras",
    "LSTMCellKeras", "SimpleCNN", "SimpleCNNLite", "SimpleGRU", "SimpleLSTM",
]
