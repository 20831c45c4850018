"""The port's entry points run on the card unless the caller asks for the
CPU: with CUDA absent, their default device raises RuntimeError instead of
falling back, and "cpu" works.  The dev entry points' `main` raises the same
way before it touches any data."""
import os

import numpy as np
import pytest
import torch

from tpu_speech_commands_torch.dev import (pallas_experiments, r3_experiments,
                                           r4_mxu_stage1)
from tpu_speech_commands_torch.export.inference_loader import load_native
from tpu_speech_commands_torch.frontend.dsp import Frontend
from tpu_speech_commands_torch.ops.cnn_kernel import make_fused_conv_block1
from tpu_speech_commands_torch.ops.frontend_kernel import MfccFrontend
from tpu_speech_commands_torch.params import ListenerParams, pr
from tpu_speech_commands_torch.serving import make_batch_scorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRU_CKPT = os.path.join(REPO, "pretrained", "direction_simple_gru.npz")
CNN_CKPT = os.path.join(REPO, "pretrained", "direction_simple_cnn.npz")


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """Checkpoint loads write the port's own `pr`, which tests/conftest.py
    does not restore."""
    snap = pr.to_dict()
    yield
    pr.override(snap)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _block1(**kw):
    variables = load_native(CNN_CKPT, "cpu").model.variables()
    return make_fused_conv_block1(variables, 30, 20, **kw)


ENTRY_POINTS = {
    "make_batch_scorer": lambda **kw: make_batch_scorer(GRU_CKPT, **kw),
    "load_native": lambda **kw: load_native(GRU_CKPT, **kw),
    "MfccFrontend": lambda **kw: MfccFrontend(ListenerParams(), "mfcc", **kw),
    "Frontend": lambda **kw: Frontend(ListenerParams(), "mfcc", **kw),
    "make_fused_conv_block1": _block1,
    "make_combined_kernel": pallas_experiments.make_combined_kernel,
    "make_reshape_kernel": pallas_experiments.make_reshape_kernel,
    "make_load_only": r3_experiments.make_load_only,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda_and_raises_without_it(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_when_asked(name):
    assert ENTRY_POINTS[name](device="cpu") is not None


def test_cpu_scorer_scores_on_the_cpu():
    scorer = make_batch_scorer(GRU_CKPT, device="cpu")
    audio = np.random.default_rng(0).uniform(-0.1, 0.1, (2, 16000))
    scores = scorer(audio.astype(np.float32))
    assert scores.device.type == "cpu" and scores.shape == (2, 5)


@pytest.mark.parametrize("main", [pallas_experiments.main, r3_experiments.main,
                                  r4_mxu_stage1.main],
                         ids=["pallas_experiments", "r3_experiments",
                              "r4_mxu_stage1"])
def test_dev_mains_refuse_to_run_without_cuda(no_cuda, main):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
