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

`ensure_native_apps` builds the two command-line apps the same way
(targets `speech_commands` and `speech_commands_stream`), one g++ call
each, both started together:

    g++ -O3 -std=c++17 -pthread native/<app>.cc native/dsp.cc \
        native/model.cc -o <app>

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
APPS = ("speech_commands", "speech_commands_stream")
APP_SOURCES = ("dsp.cc", "model.cc")  # after the app's own <app>.cc
APP_FLAGS = ("-O3", "-std=c++17", "-pthread")


class NativeBuildError(RuntimeError):
    """g++ is missing or failed on the native runtime's sources."""


def find_cxx() -> str:
    """$CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError(
            "no C++ compiler (set CXX or put g++ on PATH): the port builds "
            "native/'s library and apps from source")
    return cxx


def source_digest(cxx: str, sources=SOURCES, flags=CXX_FLAGS) -> str:
    h = hashlib.sha256(" ".join((os.path.basename(cxx),) + flags).encode())
    for path in sorted(NATIVE_DIR.glob("*.h")) + [NATIVE_DIR / s for s in sources]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(targets: dict) -> None:
    """Compile each {output path: (sources, flags)} with one g++ call, all
    started together, in a temporary directory, then rename each output
    into place: a concurrent process never loads a half-written binary,
    and a failed build leaves nothing."""
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for path, (sources, flags) in targets.items():
            cmd = [cxx, *flags, *(str(NATIVE_DIR / s) for s in sources),
                   "-o", os.path.join(tmp, path.name)]
            procs.append((path, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for _, cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} failed (exit "
                              f"{proc.returncode}):\n{out}")
        if failed:
            raise NativeBuildError("\n".join(failed))
        for path, _, _ in procs:
            os.replace(os.path.join(tmp, path.name), path)


@functools.cache
def ensure_native_library() -> Path:
    """The path of the built `libtsc.so`, compiling it first where this
    tree's sources have not been built yet."""
    lib_path = BUILD_DIR / f"libtsc_{source_digest(find_cxx())}.so"
    if not lib_path.exists():
        build({lib_path: (SOURCES, CXX_FLAGS)})
    return lib_path


@functools.cache
def ensure_native_apps() -> dict[str, Path]:
    """{app name: path of the built binary} for `APPS`, compiling first the
    apps whose sources (their own `.cc` included) have not been built yet;
    the g++ calls run in parallel."""
    cxx = find_cxx()
    sources = {app: (f"{app}.cc",) + APP_SOURCES for app in APPS}
    paths = {app: BUILD_DIR / f"{app}_{source_digest(cxx, sources[app], APP_FLAGS)}"
             for app in APPS}
    missing = {path: (sources[app], APP_FLAGS) for app, path in paths.items()
               if not path.exists()}
    if missing:
        build(missing)
    return paths
