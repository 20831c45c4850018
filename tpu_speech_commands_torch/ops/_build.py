"""Build and load the port's CUDA kernels (the idea of
`tpu_speech_commands/utils/native_build.py`, for `csrc/*.cu`).

Every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by its own nvcc call,
all started together, and one more nvcc call links the objects into a
shared library with a plain C interface, loaded with ctypes.  The library's
name carries a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the last build.  The build directory sits inside the
checkout (`build/torch_kernels/`, listed in .gitignore).  Nothing is built
when this module is imported: the first kernel launch calls `load_library`.

A failed build or load raises with nvcc's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS


class KernelBuildError(RuntimeError):
    """nvcc failed, or the built library could not be loaded."""


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then the toolkit's
    conventional install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of tpu_speech_commands_torch are built from source"
    )


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class BuildInfo:
    """What the last `load_library` did: the library path, whether it was
    compiled in this process, and nvcc's output (with `-Xptxas -v`, each
    kernel's registers, shared memory and spills)."""

    path: Path | None = None
    compiled = False
    log = ""


build_info = BuildInfo()


def _compile(lib_path: Path) -> str:
    nvcc = find_nvcc()
    units = sorted(CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent process
    # never loads a half-written library, and a failed build leaves nothing
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, unit.stem + ".o") for unit in units]
        procs = [
            subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(unit)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for unit, obj in zip(units, objs)
        ]
        outputs = [proc.communicate() for proc in procs]
        log = "".join(out + err for out, err in outputs)
        failed = [unit.name for unit, proc in zip(units, procs)
                  if proc.returncode != 0]
        if failed:
            raise KernelBuildError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp_lib = os.path.join(tmp, lib_path.name)
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp_lib, *objs],
                              capture_output=True, text=True, check=False)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed to link (exit {proc.returncode}):\n{log}")
        os.replace(tmp_lib, lib_path)
    lib_path.with_suffix(".log").write_text(log)
    return log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    lib_path = BUILD_DIR / f"libtsc_torch_kernels_{source_digest()}.so"
    if not lib_path.exists():
        build_info.log = _compile(lib_path)
        build_info.compiled = True
    else:
        log = lib_path.with_suffix(".log")
        build_info.log = log.read_text() if log.exists() else ""
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {lib_path}: {e}") from e
    build_info.path = lib_path
    return lib


def bind(name: str, n_args: int, int_args: tuple[int, ...]):
    """Look up entry point `name` and declare its argument types: the
    positions in `int_args` are C ints, every other argument a pointer (or
    the stream) passed as c_void_p.  Entry points return cudaError_t."""
    fn = getattr(load_library(), name)
    fn.argtypes = [
        ctypes.c_int if i in int_args else ctypes.c_void_p
        for i in range(n_args)
    ]
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        # a library of one dev/ ablation variant has no describer
        describe = getattr(load_library(), "tsc_cuda_error_string", None)
        why = ""
        if describe is not None:
            describe.argtypes = [ctypes.c_int]
            describe.restype = ctypes.c_char_p
            why = f" ({describe(err).decode(errors='replace')})"
        raise RuntimeError(f"{what}: CUDA error {err} at launch{why}")
