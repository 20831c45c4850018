"""Streaming latency benchmark: the fused chunk tick's latency (counterpart
of `tools/evaluation/bench_streaming.py`).

Times the serving hot path of `streaming/listener.py` and the stream
server, one tick at a time: chunk -> ring update -> incremental MFCC ->
classifier (its kernel on the card) -> softmax, for `--streams` streams in
one tick, on a model from `init_model` (random weights from seed 0: speed does not
depend on the weights).  Each tick is timed on the host's
clock between two `torch.cuda.synchronize()` calls, beside its device span
from two CUDA events; reports p50 / p90 / p99 and the real-time headroom
against the chunk cadence (a 1024-sample chunk at 16 kHz every 64 ms), and
the p50 of the tick's two layers alone: the ring update with the frame
features, and the classifier with the softmax.

    python -m tpu_speech_commands_torch.dev.bench_streaming \\
        --model_type simple_gru --streams 1024 [--device cpu]

The last line printed is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..frontend.dsp import Frontend
from ..models import MODEL_TYPES, features_to_input, init_model, score_fn
from ..params import ListenerParams
from ..serving import make_classifier
from ..streaming import init_stream_state, make_stream_step, make_stream_update


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_type", default="simple_cnn",
                        choices=list(MODEL_TYPES))
    parser.add_argument("--num_classes", type=int, default=5)
    parser.add_argument("--chunk_size", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=500)
    parser.add_argument("--streams", type=int, default=1,
                        help="concurrent streams batched into one tick")
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    p = ListenerParams()
    frontend = Frontend(p, device=device)
    update = make_stream_update(frontend, args.chunk_size)
    model, _ = init_model(args.model_type, args.num_classes, seed=0, params=p)
    classifier, path = make_classifier(model.to(device), args.model_type)
    step = make_stream_step(update, classifier, args.model_type)

    # one stream runs the Listener's state (no stream axis); more run the
    # server's, with a fill counter a stream
    n_streams = args.streams
    states = init_stream_state(p, n_streams if n_streams > 1 else None,
                               device=device)
    shape = ((n_streams, args.chunk_size) if n_streams > 1
             else (args.chunk_size,))
    rng = np.random.default_rng(0)
    chunks = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                          device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    for _ in range(20):  # warm-up
        states, scores = step(states, chunks)
    sync()

    wall, span = [], []
    start = torch.cuda.Event(enable_timing=True) if on_card else None
    end = torch.cuda.Event(enable_timing=True) if on_card else None
    for _ in range(args.iters):
        t0 = time.perf_counter()
        if on_card:
            start.record()
        states, scores = step(states, chunks)
        if on_card:
            end.record()
        sync()
        wall.append((time.perf_counter() - t0) * 1000.0)
        if on_card:
            span.append(start.elapsed_time(end))
    if not torch.isfinite(scores).all():
        raise RuntimeError("the tick's scores are not finite")

    # the tick's two layers alone, the same way: the ring update with the
    # frame features, then the classifier and softmax on its features
    _, feats = update(states, chunks)
    x = feats[None] if n_streams == 1 else feats
    split = {}
    for name, fn in (("update", lambda: update(states, chunks)),
                     ("classifier", lambda: score_fn(classifier(
                         features_to_input(x, args.model_type))))):
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1000.0)
        split[f"{name}_p50_ms"] = float(np.percentile(times, 50))

    lat = np.array(wall)
    budget_ms = 1000.0 * args.chunk_size / p.sample_rate
    pct = {q: float(np.percentile(lat, q)) for q in (50, 90, 99)}
    result = {
        "model_type": args.model_type, "streams": n_streams,
        "chunk": args.chunk_size, "classifier": path, "device": str(device),
        "iters": args.iters, "p50_ms": pct[50], "p90_ms": pct[90],
        "p99_ms": pct[99], "mean_ms": float(lat.mean()),
        "device_span_p50_ms": float(np.percentile(span, 50)) if span else None,
        "budget_ms": budget_ms, "headroom_p50": budget_ms / pct[50],
        "headroom_p99": budget_ms / pct[99], **split,
    }
    print(f"model={args.model_type} streams={n_streams} "
          f"chunk={args.chunk_size} classifier={path} device={device}")
    print(f"p50 {pct[50]:.4f} ms | p90 {pct[90]:.4f} ms | p99 {pct[99]:.4f} "
          f"ms | mean {lat.mean():.4f} ms")
    print(f"alone: update {split['update_p50_ms']:.4f} ms, classifier "
          f"{split['classifier_p50_ms']:.4f} ms at p50")
    print(f"real-time budget {budget_ms:.1f} ms/chunk -> headroom "
          f"{budget_ms / pct[50]:.1f}x at p50, {budget_ms / pct[99]:.1f}x at "
          "p99")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
