"""The port's evaluation (`tpu_speech_commands_torch/evaluation/`, `eval.py`)
against the JAX package's `evaluate_accuracy`, on the CPU.

On a synthetic corpus of the five direction classes, with a pretrained
checkpoint: the port's `eval.main` (its own features, its own classifier
on the CPU) gives the accuracy and the confusion matrix of the JAX
package's `evaluate_accuracy` on the JAX features, exactly; the port's
`evaluate_accuracy` on the JAX features too.  External formats raise.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from tpu_speech_commands.data.dataset import get_dataset as jax_get_dataset
from tpu_speech_commands.evaluation import evaluate_accuracy as jax_evaluate
from tpu_speech_commands.export.inference_loader import load_native as jax_load
from tpu_speech_commands.frontend import Frontend as JaxFrontend
from tpu_speech_commands_torch import eval as port_eval
from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
from tpu_speech_commands_torch.evaluation import evaluate_accuracy
from tpu_speech_commands_torch.export.inference_loader import load_native
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.serving import make_classifier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES_PATH = os.path.join(REPO, "configs", "direction_classes.txt")
CLASSES = ["background", "left", "right", "up", "down"]


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_corpus"))
    make_synthetic_dataset(root, CLASSES, samples_per_class=5, seed=6)
    return root


@pytest.mark.parametrize("model_type", ["simple_gru", "simple_cnn"])
def test_eval_matches_jax(model_type, corpus, tmp_path):
    ckpt = os.path.join(REPO, "pretrained", f"direction_{model_type}.npz")
    predictor = jax_load(ckpt)
    ds = jax_get_dataset(corpus, CLASSES, frontend=JaxFrontend(),
                         use_cache=False)
    want_acc, want_conf = jax_evaluate(
        predictor.model, predictor.variables, ds, model_type, CLASSES,
        batch_size=8, save_plot=False, verbose=False)
    assert want_conf.sum() == 25

    # the port's evaluate_accuracy on the JAX features, a padded last batch
    port = load_native(ckpt, "cpu")
    classifier, path = make_classifier(port.model, model_type)
    assert path == "torch"
    acc, conf = evaluate_accuracy(classifier, ds, model_type, CLASSES,
                                  batch_size=8, save_plot=False, verbose=False)
    assert acc == want_acc
    np.testing.assert_array_equal(conf, want_conf)

    # the port's eval.main end to end: its own features (cached in a copy
    # of the corpus), its classifier, on the CPU
    data = str(tmp_path / "ds")
    shutil.copytree(os.path.join(corpus, "sounds"), os.path.join(data, "sounds"))
    args = port_eval.build_parser().parse_args([
        "--model_path", ckpt, "--dataset_path", data, "--classes_path",
        CLASSES_PATH, "--batch_size", "16", "--output_path",
        str(tmp_path / "result"), "--device", "cpu"])
    acc, conf = port_eval.main(args)
    assert acc == want_acc
    np.testing.assert_array_equal(conf, want_conf)
    assert os.path.isdir(os.path.join(data, "features", "left"))


def test_eval_refuses_external_formats(tmp_path):
    for name in ("m.tflite", "m.h5", "m.onnx", "m.tscm"):
        args = port_eval.build_parser().parse_args([
            "--model_path", str(tmp_path / name), "--dataset_path", "x",
            "--classes_path", CLASSES_PATH, "--device", "cpu"])
        with pytest.raises(ValueError, match="queued in ROADMAP.md"):
            port_eval.main(args)


def test_confusion_accumulates_masked_rows():
    """The padded rows of the last batch count nowhere."""
    class Fixed:
        device = torch.device("cpu")

        def __call__(self, x):
            return torch.nn.functional.one_hot(x[:, 0, 0].long(), 3).float()

    x = np.zeros((5, 2, 2), np.float32)
    x[:, 0, 0] = [0, 1, 2, 2, 1]
    y = np.array([0, 1, 2, 1, 1], np.int32)
    from tpu_speech_commands_torch.data.dataset import Dataset

    acc, conf = evaluate_accuracy(Fixed(), Dataset(x, y), "simple_gru",
                                  ["a", "b", "c"], batch_size=4,
                                  save_plot=False, verbose=False)
    assert acc == 0.8
    np.testing.assert_array_equal(conf, [[1, 0, 0], [0, 2, 1], [0, 0, 1]])
