from .dataset import (
    Dataset,
    batch_iterator,
    extract_features_batched,
    get_audio_dataset,
    get_dataset,
    get_sample_list,
    load_audio_batch,
    pack_cache,
)
from .wav import load_wav, save_audio

__all__ = [
    "Dataset",
    "batch_iterator",
    "extract_features_batched",
    "get_audio_dataset",
    "get_dataset",
    "get_sample_list",
    "load_audio_batch",
    "load_wav",
    "pack_cache",
    "save_audio",
]
