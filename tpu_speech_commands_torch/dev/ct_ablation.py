#!/usr/bin/env python3
"""Where the CT split kernel's time goes: csrc/ct_frontend.cu with one part
cut out at a time, each built beside the shipped library and timed in turns
on the card.

    python -m tpu_speech_commands_torch.dev.ct_ablation [--batch 8192]
        [--iters 20]

Cuts (each a text substitution in a copy of the source; the kernel's output
is wrong without the part, only its time is read):

  stage1_loads    stage 1 reads no audio (its butterfly runs on made-up
                  samples): the L2 re-reads of the frames, one pass a residue
  stage2_fma      stage 2's multiply-adds become one add, so its operand
                  loads from shared memory go too: the product itself
  stage2_ring     no stage-2 matrix is copied into the K-slice ring
  filterbank      no filter sums (the energy column stays)

Times: CUDA events over `--iters` launches of the (F, F) and (T, F)
instantiations at the default config, gain 1, every variant in the order
base, cuts, then reversed.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _build, ct_kernel
from ..params import ListenerParams
from . import card_line, device_audio

CUTS = {
    "stage1_loads": ("x[q][i] = load_x(a, p + i * kLanes, scale);",
                     "x[q][i] = scale * static_cast<float>(i + q + b);"),
    "stage2_fma": ("acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);",
                   "acc[i][j] = ar[i] + br[j];"),
    "stage2_ring": ("      cp_async16(smem_addr(dst + kr * LD + 4 * c4),\n"
                    "                 mat + (size_t)(ks * kBK + kr) * LD + 4 * c4);",
                    ""),
    "filterbank": ("for (int j = jr.x; j < jr.y; ++j) {",
                   "for (int j = jr.x; j < jr.x; ++j) {"),
}


def variant_sources() -> dict:
    """name -> the kernel source with that part cut ("base": as shipped);
    ValueError if a cut's text is not in the source exactly once."""
    src = (_build.CSRC_DIR / "ct_frontend.cu").read_text()
    out = {"base": src}
    for name, (old, new) in CUTS.items():
        if src.count(old) != 1:
            raise ValueError(f"cut {name}: its text is not in ct_frontend.cu once")
        out[name] = src.replace(old, new)
    return out


def inlined_source(filename: str, csrc=None) -> str:
    """csrc/<filename> (or that of another `csrc` directory) with each
    `#include "X.cuh"` of its directory replaced by that header's text, so
    that a text edit reaches the code a kernel shares with another and the
    edited copy builds on its own."""
    csrc = Path(csrc) if csrc else _build.CSRC_DIR
    src = (csrc / filename).read_text()
    for header in sorted(csrc.glob("*.cuh")):
        text = header.read_text().replace("#pragma once\n", "")
        src = src.replace(f'#include "{header.name}"\n', text)
    return src


def build(sources: dict, stem: str = "ct", logs: dict | None = None,
          flags: dict | None = None) -> dict:
    """Compile each source into its own library (one nvcc each, all started
    together) in a temporary directory under the build directory; the
    copies include csrc/'s headers from there.  nvcc's output (with
    `-Xptxas -v`) goes to `logs[name]` when `logs` is given; `flags[name]`,
    where given, are more nvcc arguments for that source (-D switches)."""
    nvcc = _build.find_nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    procs = {}
    for name, src in sources.items():
        cu = f"{tmp}/{stem}_{name}.cu"
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, *(flags or {}).get(name, ()), "-I",
             str(_build.CSRC_DIR), "-shared", "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if logs is not None:
            logs[name] = log
        if proc.returncode:
            raise _build.KernelBuildError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(f"{tmp}/{stem}_{name}.so")
    return libs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    libs = build(variant_sources())
    p = ListenerParams()
    audio = device_audio(args.batch, p.max_samples, 0, dev)
    consts = ct_kernel.CtConstants(p, "mfcc", dev)
    gain = torch.ones(1, dtype=torch.float32, device=dev)
    shipped = _build.load_library
    times = {}
    try:
        for paired in (False, True):
            def launch():
                return ct_kernel.ct_frontend_cuda(audio, gain, consts, p,
                                                  paired, _split=True)

            for name in list(libs) + list(libs)[::-1]:
                _build.load_library = lambda lib=libs[name]: lib
                launch()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    launch()
                end.record()
                end.synchronize()
                times.setdefault((paired, name), []).append(
                    start.elapsed_time(end) / args.iters)
    finally:
        _build.load_library = shipped
    for (paired, name), ms in times.items():
        print(f"{'(T, F)' if paired else '(F, F)'} {name:13s} "
              + ", ".join(f"{t:.4f}" for t in ms) + " ms", flush=True)
    return times


if __name__ == "__main__":
    main()
