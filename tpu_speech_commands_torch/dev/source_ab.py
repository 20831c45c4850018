#!/usr/bin/env python3
"""The register-resident FFT kernels built from another checkout's sources
against this one's, timed in turns on the card: the FFT kernel's register
body (csrc/mfcc_frontend.cu) at the default config and route ct's
mixed-radix FFT (csrc/mixed_fft_frontend.cu) at n_fft = window = 768 (hop
512) and 1536 (hop 256), both on their shared csrc/register_fft.cuh.

    python -m tpu_speech_commands_torch.dev.source_ab --other DIR/csrc
        [--batch 8192] [--iters 20]

Each source is built with its own directory's headers inlined
(`ct_ablation.inlined_source`), one library a checkout and source, and run
through this checkout's wrappers (the C entry points must match).  Every
run's features are held to the plain version at FEAT_ATOL / FEAT_RTOL after
its warm-up launch; times are CUDA events over `--iters` launches, in the
order other, this, this, other.  The `-Xptxas -v` lines of each register
kernel (registers, spills) are printed for both.
"""
from __future__ import annotations

import argparse
import re

import torch

from ..device import resolve_device
from ..ops import _build, ct_kernel, frontend_kernel
from ..params import ListenerParams
from . import card_line, check_features, device_audio
from .ct_ablation import build, inlined_source

UNITS = ("mfcc_frontend.cu", "mixed_fft_frontend.cu")
# label: (the source, the config's keyword arguments)
CONFIGS = {
    "register body, n_fft 1024": ("mfcc_frontend.cu", {}),
    "mixed FFT, n_fft 768": ("mixed_fft_frontend.cu",
                             {"n_fft": 768, "window_t": 0.048}),
    "mixed FFT, n_fft 1536, hop 256": ("mixed_fft_frontend.cu",
                                       {"n_fft": 1536, "window_t": 0.096,
                                        "hop_t": 0.016}),
}


def register_ptxas(log: str) -> list:
    """The `-Xptxas -v` lines of the register kernels in an nvcc log (named
    register_fft_kernel, or fft_frontend_kernel and mixed_fft_kernel before
    the two shared one body): each kernel's name line followed by its
    spills and registers lines."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and re.search(
                r"(register_fft|fft_frontend|mixed_fft)_kernel", line):
            out.append(re.sub(r"^ptxas info\s*:\s*", "", line))
            out.extend(ln for ln in lines[i + 1:i + 4]
                       if "registers" in ln or "spill" in ln)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's csrc/ directory")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    sources = {(tag, unit): inlined_source(unit, csrc)
               for tag, csrc in (("other", args.other), ("this", None))
               for unit in UNITS}
    names = {key: f"{key[0]}_{key[1][:-3]}" for key in sources}
    logs = {}
    libs = build({names[k]: src for k, src in sources.items()}, "ab", logs)
    for key, name in names.items():
        print(f"{name}: " + "; ".join(register_ptxas(logs[name])), flush=True)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    shipped = _build.load_library
    times = {}
    try:
        for label, (unit, kw) in CONFIGS.items():
            p = ListenerParams(**kw)
            audio = device_audio(args.batch, p.max_samples, 0, dev)
            # every config is CT-eligible: the CT plain version is the
            # function both kernels compute
            ct_consts = ct_kernel.CtConstants(p, "mfcc", dev)
            want = ct_kernel.ct_frontend_plain(audio, None, ct_consts, p)
            if unit == "mfcc_frontend.cu":
                consts = frontend_kernel.KernelConstants(p, "mfcc", dev)

                def launch():
                    return frontend_kernel.mfcc_frontend_cuda(audio, gain,
                                                              consts, p)
            else:
                def launch():
                    return ct_kernel.ct_frontend_cuda(audio, gain, ct_consts,
                                                      p)
            for tag in ("other", "this", "this", "other"):
                lib = libs[names[(tag, unit)]]
                _build.load_library = lambda lib=lib: lib
                check_features(f"{tag} {label}", launch(), want)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    launch()
                end.record()
                end.synchronize()
                times.setdefault((label, tag), []).append(
                    start.elapsed_time(end) / args.iters)
            del audio, want
    finally:
        _build.load_library = shipped
    for (label, tag), ms in times.items():
        print(f"{label:32s} {tag:5s} " + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms  (B = {args.batch}, {card_line()})", flush=True)
    return times


if __name__ == "__main__":
    main()
