"""The kernel build: a failed nvcc raises with its output, a missing nvcc
raises, and the library name follows the sources.  A stand-in `nvcc` script
takes the compiler's place, so these run without a CUDA toolkit."""
import os
import stat

import pytest

from tpu_speech_commands_torch.ops import _build


def _fake_nvcc(tmp_path, body):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path / "cuda")


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(
        tmp_path, "echo 'error: expected a ;' >&2\nexit 2\n"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="expected a ;"):
        _build._compile(tmp_path / "build" / "lib.so")
    assert not (tmp_path / "build" / "lib.so").exists()
    assert os.listdir(tmp_path / "build") == []  # no half-written library


def test_build_passes_hopper_flags_and_every_source(tmp_path, monkeypatch):
    args_file = tmp_path / "args"
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(
        tmp_path,
        f'echo "$@" > {args_file}\n'
        'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n'))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = tmp_path / "build" / "lib.so"
    _build._compile(lib)
    assert lib.exists() and lib.with_suffix(".log").exists()
    args = args_file.read_text()
    assert "arch=compute_90a,code=sm_90a" in args
    for src in ("mfcc_frontend.cu", "gru_classifier.cu"):
        assert src in args


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()


def test_digest_follows_sources(tmp_path, monkeypatch):
    first = _build.source_digest()
    assert first == _build.source_digest()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC_DIR.glob("*.cu"):
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert _build.source_digest() == first
    (csrc / "mfcc_frontend.cu").write_text("// edited\n")
    assert _build.source_digest() != first
