from .factory import (
    CNN_MODEL_TYPES,
    MODEL_TYPES,
    features_to_input,
    get_model,
    is_cnn,
    score_fn,
)
from .rnn import GRUCellKeras, LSTMCellKeras, SimpleGRU, SimpleLSTM

__all__ = [
    "CNN_MODEL_TYPES", "MODEL_TYPES", "features_to_input", "get_model",
    "is_cnn", "score_fn", "GRUCellKeras", "LSTMCellKeras", "SimpleGRU",
    "SimpleLSTM",
]
