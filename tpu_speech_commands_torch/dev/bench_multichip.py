"""Multi-device serving throughput: the sharded scorer (`make_batch_scorer(
..., mesh=)`) reported as windows/s per card (counterpart of
`tools/evaluation/bench_multichip.py`).

    python -m tpu_speech_commands_torch.dev.bench_multichip \\
        --model_type simple_cnn --batch_per_device 2048 [--devices 4]
    python -m tpu_speech_commands_torch.dev.bench_multichip \\
        --devices cuda:0,cuda:0      # two shards sharing one card

`--devices N` puts N distinct cards on the data axis (default: every
visible card); a comma-separated list names the devices, one shard each,
and may repeat a card.  `--replicas R` builds the hybrid ('replica',
'data', 'model') mesh with R replicas of the data axis.  Each shard's audio
(standard normal from a numpy seed, f32) lives on its device, and
`--k_inner` calls, each with its own gain 1 + 1e-9 i (every call computes),
are timed on the host clock after a warm-up, up to a synchronize of every
device, best of three; each call's scores are summed into an on-device
checksum.  The weights are the model type's shipped checkpoint (speed does
not depend on them).  Prints the cards' names and power limits
(nvidia-smi), then one line and a JSON object: windows/s in all and per
card, labelled where shards share a card.  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..parallel import batch_shards, make_hybrid_mesh, make_mesh
from ..serving import make_batch_scorer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODEL_TYPES = ("simple_cnn", "simple_cnn_lite", "simple_gru", "simple_lstm")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", default=None,
                        help="N distinct cards, or a comma-separated device "
                             "list (default: every visible card)")
    parser.add_argument("--replicas", type=int, default=None,
                        help="hybrid mesh: this many replicas of the data "
                             "axis; the batch shards over both")
    parser.add_argument("--batch_per_device", type=int, default=2048)
    parser.add_argument("--k_inner", type=int, default=8)
    parser.add_argument("--model_type", default="simple_cnn",
                        choices=MODEL_TYPES)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    return parser


def bench_mesh(args):
    devices, n_data = None, None
    if args.devices and args.devices.isdigit():
        n_data = int(args.devices)
    elif args.devices:
        devices = args.devices.split(",")
    if args.replicas:
        if devices is not None:
            n_data = len(devices) // args.replicas
        return make_hybrid_mesh(args.replicas, n_data, devices=devices)
    return make_mesh(n_data=n_data, devices=devices)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_multichip needs CUDA")
    mesh = bench_mesh(args)
    shards = [torch.device(d) for d in mesh.batch_devices()]
    n_shards, cards = batch_shards(mesh), len(set(shards))
    ckpt = os.path.join(REPO, "pretrained", f"direction_{args.model_type}.npz")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    scorer = make_batch_scorer(ckpt, compute_dtype=dtype, mesh=mesh)
    rng = np.random.default_rng(0)
    parts = [torch.tensor(rng.standard_normal(
        (args.batch_per_device, 16000), dtype=np.float32), device=d)
        for d in shards]
    audio = parts if n_shards > 1 else parts[0]
    gains = 1.0 + 1e-9 * torch.arange(args.k_inner, dtype=torch.float32,
                                      device=shards[0])
    checksum = torch.zeros((), device=shards[0])
    checksum += scorer(audio, gains[0]).sum()  # warm-up

    def sync():
        for d in set(shards):
            torch.cuda.synchronize(d)

    best = 0.0
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        for i in range(args.k_inner):
            checksum += scorer(audio, gains[i]).sum()
        sync()
        best = max(best, args.k_inner * args.batch_per_device * n_shards
                   / (time.perf_counter() - t0))
    if not torch.isfinite(checksum).item():
        raise RuntimeError("the checksum is not finite")
    card_lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    sharing = (f" ({n_shards} shards sharing {cards} card"
               f"{'s' if cards > 1 else ''})" if cards < n_shards else "")
    result = {
        "mesh": mesh.shape, "devices": [str(d) for d in shards],
        "model_type": args.model_type, "dtype": args.dtype,
        "batch_per_device": args.batch_per_device,
        "windows_per_s": best, "windows_per_s_per_card": best / cards,
        "cards": cards, "shards_share_a_card": cards < n_shards,
        "paths": scorer.paths, "card": card_lines.splitlines()}
    print(card_lines)
    print(f"mesh {mesh.shape}{sharing}: {best:,.0f} windows/s total, "
          f"{best / cards:,.0f} windows/s/card")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
