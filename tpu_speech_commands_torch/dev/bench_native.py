"""Native deployment benchmark on the host CPU (counterpart of
`tools/evaluation/bench_native.py`, with its flags and its table and JSON
line).

Runs every family's `.tscm` through the `speech_commands` app in f32 and
in dynamic-range int8 (a `.tscm` v2 from the port's
`export_native(..., quantize=True)`), and the `speech_commands_stream`
app's per-chunk step, and prints a table and one JSON line.  The apps are
built from `native/` by g++ (`utils.native_build.ensure_native_apps`, no
cmake).  Every time is a host CPU time (the line before the table names
the CPU), not the card's.  The reference baselines are the numbers its
inference README publishes (TFLite RNN: feature 3.051 ms + invoke 2.216
ms; MNN CNN: 3.199 + 0.575 ms).

    python -m tpu_speech_commands_torch.dev.bench_native [--loop_count 1000] \\
        [--runs 5] [--model_dir pretrained]
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import re
import statistics
import subprocess
import sys
import tempfile

from ..export.native_format import export_native
from ..utils.native_build import ensure_native_apps

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FAMILIES = ["simple_cnn", "simple_cnn_lite", "simple_gru", "simple_lstm"]
# reference invoke baselines per architecture class (ms)
REF_INVOKE = {"simple_cnn": 0.575, "simple_cnn_lite": 0.575,
              "simple_gru": 2.216, "simple_lstm": 2.216}


def host_cpu(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The host CPU as /proc/cpuinfo names it: its `model name`, or where
    that reads `unknown` (as under some virtualised kernels) its vendor,
    family and model numbers; then the CPU count and the first CPU's MHz."""
    fields, count = {}, 0
    try:
        with open(cpuinfo) as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                count += key == "processor"
                fields.setdefault(key, value.strip())
    except OSError:
        return platform.processor() or "unknown CPU"
    name = fields.get("model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{fields.get('vendor_id', '?')} family "
                f"{fields.get('cpu family', '?')} model "
                f"{fields.get('model', '?')} (model name unknown)")
    mhz = fields.get("cpu MHz")
    return f"{name}, {count} CPUs" + (f" at {float(mhz):.0f} MHz"
                                      if mhz else "")


def invoke_ms(app, model, wav, loop_count, runs, threads):
    vals = []
    for _ in range(runs):
        out = subprocess.run(
            [str(app), "--model", model, "--wav", wav,
             "--loop_count", str(loop_count), "--threads", str(threads)],
            capture_output=True, text=True, check=True).stdout
        m = re.search(r"model invoke time: ([\d.]+) ms", out)
        if not m:
            raise RuntimeError(f"no invoke line in output:\n{out}")
        vals.append(float(m.group(1)))
    return statistics.median(vals)


def stream_step_us(app, model, wav, threads):
    out = subprocess.run(
        [str(app), "--model", model, "--wav", wav, "--timing",
         "--threads", str(threads)],
        capture_output=True, text=True, check=True).stdout
    m = re.search(r"per-chunk step time: ([\d.]+) us", out)
    if not m:
        raise RuntimeError(f"no timing line in output:\n{out}")
    return float(m.group(1))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--loop_count", type=int, default=1000)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--wav", default=os.path.join(REPO, "example",
                                                  "right_1.wav"))
    ap.add_argument("--model_dir", default=os.path.join(REPO, "pretrained"),
                    help="directory of direction_<family>.{npz,tscm}")
    return ap


def main(argv=None):
    """Returns the JSON line's object, or None when no family's files are
    in --model_dir."""
    args = build_parser().parse_args(argv)
    apps = ensure_native_apps()
    print(f"host CPU: {host_cpu()} (every time below is a host CPU time)")
    rows = []
    with tempfile.TemporaryDirectory() as td:
        for fam in FAMILIES:
            ckpt = os.path.join(args.model_dir, f"direction_{fam}.npz")
            blob = os.path.join(args.model_dir, f"direction_{fam}.tscm")
            # the int8 export below reads the .npz checkpoint too
            if not (os.path.exists(blob) and os.path.exists(ckpt)):
                print(f"skip {fam}: missing blob/checkpoint in "
                      f"{args.model_dir}", file=sys.stderr)
                continue
            qblob = os.path.join(td, f"{fam}_q.tscm")
            export_native(ckpt, qblob, quantize=True)
            f32 = invoke_ms(apps["speech_commands"], blob, args.wav,
                            args.loop_count, args.runs, args.threads)
            i8 = invoke_ms(apps["speech_commands"], qblob, args.wav,
                           args.loop_count, args.runs, args.threads)
            step = stream_step_us(apps["speech_commands_stream"], blob,
                                  args.wav, args.threads)
            rows.append((fam, f32, i8, step))
            ref = REF_INVOKE[fam]
            print(f"{fam:17s} invoke f32 {f32:7.3f} ms ({ref / f32:6.1f}x "
                  f"ref) | int8 {i8:7.3f} ms | stream step {step:7.1f} us "
                  f"({64000.0 / step:6.0f}x real-time)")

    if not rows:
        print(f"no models found in {args.model_dir}", file=sys.stderr)
        return None
    # headline: the RNN family (the reference's own headline config)
    gru = next((r for r in rows if r[0] == "simple_gru"), rows[0])
    result = {
        "metric": "native_invoke_ms_simple_gru",
        "value": gru[1],
        "unit": "ms",
        "vs_baseline": REF_INVOKE["simple_gru"] / gru[1],
        "rows": [{"family": f, "invoke_f32_ms": a, "invoke_int8_ms": b,
                  "stream_step_us": c} for f, a, b, c in rows],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
