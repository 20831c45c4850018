"""tpu_speech_commands_torch — the PyTorch / CUDA port of tpu_speech_commands.

The JAX package beside it stays the reference: every module here keeps the
name of its JAX counterpart and is tested against it on the same inputs.
This package imports torch, numpy and the standard library, never jax and
nothing of the JAX package.  Its kernels are written by hand in CUDA C++ for
Hopper (`csrc/`), each with a plain PyTorch version beside it (`ops/`).  Its
entry points run on the card unless the caller asks for the CPU.

    from tpu_speech_commands_torch.serving import make_batch_scorer
    scorer = make_batch_scorer("pretrained/direction_simple_gru.npz", "cuda")
    scores = scorer(audio)                  # (B, 16000) -> (B, C)
"""
from .params import ListenerParams, inject_params, pr, save_params

__all__ = ["ListenerParams", "inject_params", "pr", "save_params"]
