"""Incremental streaming feature extraction (counterpart of
`tpu_speech_commands/streaming/feature_stream.py`).

The reference ring-buffer update (`listen.py:96-114`) as a fixed-shape
state transition on tensors, so a chunk tick is a fixed sequence of
launches with no host round trip:

reference state (ragged)            ->  fixed-shape state here
  audio_buffer (buffer_samples,)        audio   (buffer_samples,) f32
  window_audio (variable length)        fill    int32, the pending-sample
                                        count; the pending samples ARE the
                                        tail of `audio`, so no second buffer.
                                        Scalar for a single stream; carries
                                        the stream axis in batched serving so
                                        streams join and leave independently
  mfccs (n_features, n_mfcc)            feats   (n_features, n_mfcc) f32

Per chunk (chunk_size fixed): append the chunk to the ring, grow `fill`; if
fill >= window, emit n_new = 1 + (fill-window)//hop frames exactly like
sonopy's chop_array over window_audio, consume n_new*hop pending samples,
and roll the feature buffer left by n_new.  n_new lives on the device and
is bounded by MAX_NEW = 1 + (chunk_size-1)//hop, so frames are computed
at MAX_NEW positions and the valid ones are kept by a gather: no `.item()`
and no sync inside the update.

The frame features are the plain chain's products
(`frontend/dsp.py::Frontend.features_from_frames`), as the JAX streamer
computes them with plain XLA products outside any Pallas kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..frontend.dsp import Frontend, add_deltas
from ..models import features_to_input, score_fn
from ..params import ListenerParams, pr


@dataclass(frozen=True)
class StreamConfig:
    chunk_size: int
    params: ListenerParams

    @property
    def max_new(self) -> int:
        """Bound on frames emitted per chunk: the pending length peaks at
        window-1+chunk, giving 1 + (chunk-1)//hop frames."""
        return 1 + (self.chunk_size - 1) // self.params.hop_samples


def init_stream_state(params: ListenerParams | None = None,
                      n_streams: int | None = None, device=DEFAULT_DEVICE):
    """Zeroed streaming state (audio ring, pending count, feature buffer) on
    `device` (the card unless the caller passes "cpu"; RuntimeError for
    CUDA without CUDA).  With n_streams, every field (the pending-sample
    counter `fill` too) carries a leading stream axis, so streams may join,
    leave, or reset at different times."""
    p = params or pr
    device = resolve_device(device)
    lead = () if n_streams is None else (n_streams,)
    return {
        "audio": torch.zeros(lead + (p.buffer_samples,), dtype=torch.float32,
                             device=device),
        "fill": torch.zeros(lead, dtype=torch.int32, device=device),
        "feats": torch.zeros(lead + (p.n_features, p.n_mfcc),
                             dtype=torch.float32, device=device),
    }


def reset_streams(state, mask):
    """Zero the state of streams where `mask` is True (shape (n_streams,)),
    so a new caller of a vacated serving slot never sees the previous
    stream's audio.  Returns a new state; needs a batched state
    (init_stream_state(n_streams=...))."""
    mask = torch.as_tensor(mask, dtype=torch.bool,
                           device=state["fill"].device)
    if state["fill"].ndim != 1 or mask.ndim != 1:
        raise ValueError(
            "reset_streams needs a batched stream state (per-stream fill)"
        )
    return {
        "audio": state["audio"].masked_fill(mask[:, None], 0.0),
        "fill": state["fill"].masked_fill(mask, 0),
        "feats": state["feats"].masked_fill(mask[:, None, None], 0.0),
    }


def make_stream_update(frontend: Frontend, chunk_size: int):
    """Build the (state, chunk) -> (state, features) transition on the
    frontend's device."""
    p = frontend.params
    cfg = StreamConfig(chunk_size, p)
    window, hop = p.window_samples, p.hop_samples
    buf_len = p.buffer_samples
    max_new = cfg.max_new
    if max_new > p.n_features:
        raise ValueError(
            "chunk_size too large for incremental update; lower chunk_size"
        )
    # start0 = buf_len - fill must stay >= 0: fill peaks at window - 1 +
    # chunk_size right before extraction, beyond which the clipped gather
    # below would silently emit corrupted frames
    if window + chunk_size - 1 > buf_len:
        raise ValueError(
            "chunk_size too large for the audio buffer: need "
            "window_samples + chunk_size - 1 <= buffer_samples"
        )
    device = frontend.device
    # the audio every emitted frame reads: max_new frames, hop apart
    span = torch.arange(window + (max_new - 1) * hop, device=device)
    rows = torch.arange(p.n_features, device=device)

    @torch.no_grad()
    def update(state, chunk):
        """state and chunk may carry identical leading stream axes.  `fill`
        is either a shared scalar (lock-step streams) or carries the stream
        axis itself (independent join, leave and reset per stream)."""
        if chunk.shape[-1] != chunk_size:
            raise ValueError(f"chunk of {chunk.shape[-1]} samples, the "
                             f"update takes {chunk_size}")
        if chunk.dtype != torch.float32:
            # int16 PCM would enter the ring 32768x too large: decode first
            raise TypeError(f"chunk must be float32 audio, got {chunk.dtype}")
        audio = torch.cat([state["audio"][..., chunk_size:], chunk], dim=-1)
        fill = state["fill"] + chunk_size
        # 0 while fill < window: then (fill - window) // hop <= -1
        n_new = (1 + torch.div(fill - window, hop,
                               rounding_mode="floor")).clamp_(min=0)
        lead = audio.shape[:-1]

        # window_audio == the trailing `fill` samples of the stream; frame j
        # covers window_audio[j*hop : j*hop+window].  One gather of each
        # stream's span, then the frames as views of it.  Rows j >= n_new
        # read clipped positions and are dropped by the roll below; rows
        # j < n_new are in bounds (fill >= window + (n_new-1)*hop).
        start0 = (buf_len - fill).expand(lead)
        offs = (start0[..., None].long() + span).clamp_(0, buf_len - 1)
        # contiguous: torch.matmul runs the strided view as a product
        # batched over the streams, far slower on the card than one GEMM
        frames = torch.gather(audio, -1, offs).unfold(-1, window,
                                                      hop).contiguous()
        new_feats = frontend.features_from_frames(frames)  # (..., max_new, F)

        # roll the feature buffer left by n_new, append the n_new valid rows
        stacked = torch.cat([state["feats"], new_feats], dim=-2)
        take = n_new.expand(lead)[..., None].long() + rows
        feats = torch.gather(
            stacked, -2, take[..., None].expand(take.shape + (p.n_mfcc,)))
        fill = fill - n_new * hop
        new_state = {"audio": audio, "fill": fill, "feats": feats}
        # deltas on the output copy only: the reference mutates its state
        # here (listen.py:108-110), which breaks on the next chunk; the
        # state stays un-deltaed, as in the JAX streamer
        out = add_deltas(feats) if p.use_delta else feats
        return new_state, out

    return update


def make_stream_step(update, classifier, model_type: str):
    """The fused tick (state, chunk) -> (state, scores): the ring update,
    the classifier (a `serving.make_classifier` wrapper: its kernel on the
    card, the plain module on the CPU), softmax.  A state without a stream
    axis scores one window and returns (C,) scores, else (N, C)."""

    @torch.no_grad()
    def step(state, chunk):
        state, feats = update(state, chunk)
        single = feats.ndim == 2
        x = features_to_input(feats[None] if single else feats, model_type)
        scores = score_fn(classifier(x))
        return state, scores[0] if single else scores

    return step
