"""Build the C++ runtime in `native/` for the port's ctypes binding
(counterpart of `tpu_speech_commands/utils/native_build.py`).

The JAX package configures `native/` with cmake and ninja.  The port needs
only the `tsc` shared library (`native/CMakeLists.txt`, target `tsc`), and
builds it with one g++ call:

    g++ -O3 -std=c++17 -shared -fPIC -pthread \\
        native/model_capi.cc native/dsp.cc native/model.cc -o libtsc.so

into `build/native_torch/` (listed in .gitignore), named after a digest of
the sources, the headers and the command, as `ops/_build.py` names the
kernel library: an edit rebuilds, an unchanged tree reuses the last build.
Nothing is built when this module is imported.  A failed build raises
`NativeBuildError` with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO / "native"
BUILD_DIR = REPO / "build" / "native_torch"
SOURCES = ("model_capi.cc", "dsp.cc", "model.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class NativeBuildError(RuntimeError):
    """g++ is missing or failed on the native runtime's sources."""


def find_cxx() -> str:
    """$CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError(
            "no C++ compiler (set CXX or put g++ on PATH): the port builds "
            "native/libtsc.so from source")
    return cxx


def source_digest(cxx: str) -> str:
    h = hashlib.sha256(" ".join((os.path.basename(cxx),) + CXX_FLAGS).encode())
    for path in sorted(NATIVE_DIR.glob("*.h")) + [NATIVE_DIR / s for s in SOURCES]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def ensure_native_library() -> Path:
    """The path of the built `libtsc.so`, compiling it first where this
    tree's sources have not been built yet."""
    cxx = find_cxx()
    lib_path = BUILD_DIR / f"libtsc_{source_digest(cxx)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent process
    # never loads a half-written library, and a failed build leaves nothing
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = os.path.join(tmp, lib_path.name)
        cmd = [cxx, *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES),
               "-o", tmp_lib]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path
