"""Cross-implementation MFCC comparator, the frontend parity harness
(counterpart of `tools/audio_process/mfcc_feature.py`, with its flags and
`--device`).

    python -m tpu_speech_commands_torch.mfcc_feature \\
        --audio_file example/left_1.wav [--output_path dump] [--device cpu]

Makes one clip's features with every implementation the port has and
prints each one's max |delta| from the float64 oracle (`frontend/
numpy_ref.py`); `--output_path` also dumps each to mfcc_<name>.txt:

- `numpy_oracle`: the float64 oracle;
- `torch_cpu`: the plain PyTorch chain on the CPU;
- `frontend_kernel`: `ops.MfccFrontend` on `--device` (on the card the
  config's route: the FFT kernel at the default config);
- `fast_math_kernel`: `MfccFrontend(fast_math=True)` on `--device` (on the
  card the bf16 tensor-core DFT kernel; its bf16 frames and DFT matrix put
  it further from the oracle than the f32 legs);
- `native_cpp`: the C++ library of `native/` (`native_binding`), built
  with g++ at first use;
- `librosa`, where it is installed (its own mel scale: not comparable).

A failure of either kernel leg raises.  Only `native_cpp` and `librosa`
may be skipped, with the reason printed.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data.wav import load_wav
from .device import DEFAULT_DEVICE, resolve_device
from .frontend import numpy_ref
from .frontend.dsp import Frontend
from .ops.frontend_kernel import MfccFrontend
from .params import inject_params, pr


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--audio_file", required=True)
    parser.add_argument("--output_path", default=None)
    parser.add_argument("--params_path", default=None)
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


def load_padded(path: str, params=None) -> np.ndarray:
    """A wav at the config's rate, cut or left-padded to max_samples."""
    p = params or pr
    audio = load_wav(path, p.sample_rate)[: p.max_samples]
    if len(audio) < p.max_samples:
        audio = np.concatenate([np.zeros(p.max_samples - len(audio)), audio])
    return audio


def main(argv=None) -> dict:
    """Returns {leg: (frames, coefficients) float array}, the oracle's
    under "numpy_oracle", each kernel leg's path under "<leg>_path"."""
    args = build_parser().parse_args(argv)
    if args.params_path:
        inject_params(args.params_path)
    device = resolve_device(args.device)

    padded = load_padded(args.audio_file)
    batch = torch.tensor(padded[None], dtype=torch.float32)

    results = {"numpy_oracle": numpy_ref.vectorize_raw(padded)}
    paths = {}
    results["torch_cpu"] = Frontend(pr, device="cpu")(batch)[0].numpy()
    for leg, fast_math in (("frontend_kernel", False),
                           ("fast_math_kernel", True)):
        fe = MfccFrontend(pr, "mfcc", device, fast_math=fast_math)
        with torch.no_grad():
            results[leg] = fe(batch.to(device))[0].float().cpu().numpy()
        paths[f"{leg}_path"] = fe.path
    try:
        from .native_binding import NativeFrontend

        results["native_cpp"] = NativeFrontend(pr)(padded.astype(np.float32))
    except (OSError, RuntimeError) as e:  # the C++ library is built by g++
        print(f"native_cpp unavailable: {e}")
    try:
        import librosa

        results["librosa"] = librosa.feature.mfcc(
            y=padded.astype(np.float32), sr=pr.sample_rate,
            n_mfcc=pr.n_mfcc).T
    except ImportError:
        print("librosa unavailable: not installed")

    base = results["numpy_oracle"]
    print(f"frames x coeffs: {base.shape}")
    for name, arr in results.items():
        if args.output_path:
            os.makedirs(args.output_path, exist_ok=True)
            np.savetxt(os.path.join(args.output_path, f"mfcc_{name}.txt"),
                       arr, fmt="%.6f")
        path = paths.get(f"{name}_path")
        label = f"{name} [{path}]" if path else name
        if name == "numpy_oracle" or arr.shape != base.shape:
            note = ("" if name == "numpy_oracle"
                    else " (shape differs: not comparable)")
            print(f"{label}: shape {arr.shape}{note}")
            continue
        print(f"{label}: max |delta| vs oracle = "
              f"{np.abs(arr - base).max():.3e}")
    return {**results, **paths}


if __name__ == "__main__":
    main()
