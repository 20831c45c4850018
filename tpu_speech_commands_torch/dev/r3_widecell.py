#!/usr/bin/env python3
"""The CT frontend's wide-cell variant on the card (counterpart of
`tools/dev/r3_widecell.py`).

    python -m tpu_speech_commands_torch.dev.r3_widecell [--batch 8192]
        [--iters 30]

The JAX script builds its frames as one wide lane-packed cell stream and
runs the butterfly's first two radix stages on 512 lanes at once, in the
association order of `_dft8_real`, and asserts that the result is bit for
bit the production kernel's.  Those are layouts of the TPU's vregs; on this
card the frames are read along b and the butterfly runs per sample in that
same order, so the wide-cell variant IS the CT kernel's (F, F)
instantiation, time-major.  The counterpart of the bit-exactness assert:
the variant's time-major output must be torch.equal to the batch-major
launch's, transposed (the same sums stored through the other index;
RuntimeError otherwise), and it is held to the production frontend, the FFT
kernel, within the port's f32 feature bound, on the first 64 rows.  The variant and
the production frontend ("prod") are timed with CUDA events over `--iters`
launches at gains 1 + i / 1000.
"""
from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.frontend_kernel import MfccFrontend
from ..params import pr
from . import best_rate, card_line, check_features, ct_variant, device_audio

N_CHECK = 64


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    p = pr.replace()
    audio = device_audio(args.batch, p.max_samples, 0, dev)
    gains = 1.0 + torch.arange(args.iters, dtype=torch.float32, device=dev) / 1e3
    batch_major = ct_variant(p, dev, False, False, time_major=False)
    wide = ct_variant(p, dev, False, False, time_major=True)
    with torch.inference_mode():
        small = audio[:N_CHECK]
        got = wide(small)
        if not torch.equal(got, batch_major(small).transpose(0, 1)):
            raise RuntimeError("widecell is not bit-exact with the batch-major "
                               "launch")
        prod = MfccFrontend(p, "mfcc", dev)
        ref = prod(small).transpose(0, 1)
        d = check_features("widecell", got, ref)
        print(f"widecell parity: bit-exact with the batch-major launch; "
              f"max|d| vs the FFT kernel = {d:.2e}", flush=True)
        rates = {name: best_rate(fn, audio, gains)
                 for name, fn in (("prod", prod), ("widecell", wide))}
    for name, r in rates.items():
        print(f"{name:>9}: {r / 1e6:6.3f} M w/s = {1e9 / r:6.1f} ns/win",
              flush=True)
    print(f"({card})", flush=True)
    return rates


if __name__ == "__main__":
    main()
