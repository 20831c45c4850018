"""Host-side multi-stream postprocess cost: the scalar loop against the
vectorized step (counterpart of `tools/evaluation/bench_postprocess.py`,
with its flags).

The stream server advances every slot once a 64 ms chunk tick (chunk 1024
at 16 kHz); what the host spends on a slot's postprocess (argmax ->
ThresholdDecoder -> TriggerDetector) comes out of that budget.  At each
slot count, on the same synthetic score sequence:

- scalar: a Python loop over the slots (`decoder.decode` and one
  `TriggerDetector` a slot);
- vectorized: `decode_array` and one `TriggerDetectorArray` update a tick
  (the server's path, `stream_server.py`).

Host numpy only, on `streaming/decoder.py` and `streaming/trigger.py`: no
model and no device.  Both paths must fire the same number of triggers.

    python -m tpu_speech_commands_torch.dev.bench_postprocess --slots 1 1024

The last line printed is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..params import pr
from ..streaming import ThresholdDecoder, TriggerDetector, TriggerDetectorArray

CLASSES = ["background", "left", "right", "up", "down"]


def synth_scores(rng, n_slots, n_classes):
    """Softmax-like scores with occasional confident command streaks."""
    logits = rng.standard_normal((n_slots, n_classes))
    streaky = rng.random(n_slots) < 0.3
    logits[streaky, 1] += 4.0
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def run_scalar(decoder, triggers, scores):
    fired = 0
    for i in range(len(scores)):
        idx = int(scores[i].argmax())
        conf = float(scores[i, idx])
        if idx != 0:
            conf = decoder.decode(conf)
        if triggers[i].update(idx, conf):
            fired += 1
    return fired


def run_vector(decoder, detector, scores):
    idx = scores.argmax(axis=1)
    conf = scores[np.arange(len(scores)), idx].astype(np.float64)
    non_bg = idx != 0
    conf[non_bg] = decoder.decode_array(conf[non_bg])
    return int(detector.update(idx, conf).sum())


def bench(n_slots: int, ticks: int = 50, chunk_size: int = 1024) -> dict:
    """ms a tick of both paths at n_slots, and the triggers each fired
    (AssertionError if they differ)."""
    rng = np.random.default_rng(0)
    decoder = ThresholdDecoder(pr.threshold_config, pr.threshold_center)
    triggers = [TriggerDetector(chunk_size, CLASSES) for _ in range(n_slots)]
    detector = TriggerDetectorArray(chunk_size, CLASSES, n_slots=n_slots)
    score_seq = [synth_scores(rng, n_slots, len(CLASSES))
                 for _ in range(ticks)]

    fired_s = 0
    t0 = time.perf_counter()
    for scores in score_seq:
        fired_s += run_scalar(decoder, triggers, scores)
    scalar_ms = 1000.0 * (time.perf_counter() - t0) / ticks

    fired_v = 0
    t0 = time.perf_counter()
    for scores in score_seq:
        fired_v += run_vector(decoder, detector, scores)
    vector_ms = 1000.0 * (time.perf_counter() - t0) / ticks

    if fired_s != fired_v:
        raise AssertionError(f"scalar fired {fired_s}, vector {fired_v}")
    return {"slots": n_slots, "ticks": ticks, "scalar_ms": scalar_ms,
            "vector_ms": vector_ms,
            "speedup": scalar_ms / max(vector_ms, 1e-9), "fired": fired_s}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--slots", type=int, nargs="+",
                        default=[8, 64, 256, 1024, 4096])
    parser.add_argument("--ticks", type=int, default=50)
    parser.add_argument("--chunk_size", type=int, default=1024)
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    budget_ms = 1000.0 * args.chunk_size / pr.sample_rate
    print(f"chunk budget: {budget_ms:.1f} ms/tick "
          f"(chunk {args.chunk_size} @ {pr.sample_rate} Hz)")
    print(f"{'slots':>6} {'scalar ms/tick':>15} {'vector ms/tick':>15} "
          f"{'speedup':>8}")
    rows = []
    for n_slots in args.slots:
        row = bench(n_slots, args.ticks, args.chunk_size)
        rows.append(row)
        print(f"{n_slots:>6} {row['scalar_ms']:>15.3f} "
              f"{row['vector_ms']:>15.3f} {row['speedup']:>7.1f}x")
    result = {"budget_ms": budget_ms, "rows": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
