"""The torch stage of the accuracy-parity study
(`tpu_speech_commands_torch/dev/accuracy_parity.py`) against the JAX tool
`tools/evaluation/accuracy_parity.py`, on the CPU, on a tiny corpus (the
36 classes x 2 clips a class, seed 7).

The JAX tool runs its keras stage with `train_keras` replaced by a
recorder: that gives its corpus (`get_dataset` as it reads the cache), its
per-seed splits and a stage file whose `__config__` it wrote itself.

- the port's split indices select the JAX tool's train and val rows for
  seeds 0-2;
- the port's corpus: the same labels in the same order; each clip's
  features within atol 1e-4 / rtol 1e-4 of the JAX clip's (the bound
  tests/test_torch_data.py holds the plain frontend to; the cache orders
  the clips of a class by random file names, so clips are matched within
  their class); the stage configuration equal to the JAX tool's, the
  fingerprint's sums within `FINGERPRINT_RTOL`;
- the stage refusal, field by field, and before any training;
- one tiny run of the torch stage end to end against that stage file.
"""
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from tpu_speech_commands_torch.dev import accuracy_parity as parity
from tpu_speech_commands_torch.params import pr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPC, EPOCHS = 2, 1
FLAGS = ["--samples_per_class", str(SPC), "--epochs", str(EPOCHS),
         "--model_type", "simple_gru"]


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


@pytest.fixture(scope="module")
def jax_stage(tmp_path_factory):
    """The JAX tool's keras stage on the tiny corpus, Keras replaced by a
    recorder: (x, y, splits {seed: (x_train, y_train, x_val, y_val)}, the
    stage file)."""
    from tpu_speech_commands.data import dataset as jax_dataset
    from tpu_speech_commands.params import pr as jax_pr
    from tpu_speech_commands.utils import compilation_cache as cc

    work = str(tmp_path_factory.mktemp("jax_parity"))
    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "enable_compilation_cache", lambda *a, **k: None)
    mp.setenv("JAX_PLATFORMS", "cpu")
    read, splits = [], {}
    get_dataset = jax_dataset.get_dataset

    def recording_get_dataset(*args, **kw):
        read.append(get_dataset(*args, **kw))
        return read[-1]

    def fake_keras(args, model_type, seed, classes, x_train, y_train, x_val,
                   y_val):
        splits[seed] = (x_train, y_train, x_val, y_val)
        return 0.5 + seed / 100, f"keras_{model_type}_s{seed}.h5"

    mp.setattr(jax_dataset, "get_dataset", recording_get_dataset)
    snap = jax_pr.to_dict()
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_accuracy_parity",
            os.path.join(REPO, "tools", "evaluation", "accuracy_parity.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        mp.setattr(tool, "train_keras", fake_keras)
        mp.setattr("sys.argv", ["accuracy_parity", *FLAGS, "--seed", "0",
                                "1", "2", "--work_dir", work, "--stage",
                                "keras"])
        tool.main()
    finally:
        mp.undo()
        jax_pr.override(snap)
    full = read[-1]
    stage = os.path.join(work, f"keras_stage_easy_{SPC}spc_{EPOCHS}ep.json")
    return (np.asarray(full.x, np.float32), np.asarray(full.y, np.int64),
            splits, stage)


@pytest.fixture(scope="module")
def port_corpus(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("port_parity"))
    snap = pr.to_dict()
    try:
        x, y, classes = parity.build_corpus(work, SPC, "easy", "cpu")
    finally:
        pr.override(snap)
    return work, x, y, classes


def _args(**kw):
    base = dict(distribution="easy", samples_per_class=SPC, epochs=EPOCHS,
                batch_size=512, learning_rate=1e-3, val_split=0.15)
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_matches_jax_tool(jax_stage, seed):
    """split(n, seed, 0.15) picks the rows the JAX tool trained and
    validated its seed on."""
    x, y, splits, _ = jax_stage
    val_idx, train_idx = parity.split(len(x), seed, 0.15)
    x_train, y_train, x_val, y_val = splits[seed]
    np.testing.assert_array_equal(x[train_idx], x_train)
    np.testing.assert_array_equal(x[val_idx], x_val)
    np.testing.assert_array_equal(y[train_idx], y_train)
    np.testing.assert_array_equal(y[val_idx], y_val)


def test_corpus_matches_jax_tool(jax_stage, port_corpus):
    """The port's corpus against the JAX tool's: labels equal in order,
    each clip's features within atol / rtol 1e-4 of one JAX clip of its
    class (a one-to-one match), and the stage configuration accepted
    against the JAX tool's file (every field equal, the fingerprint's sums
    within FINGERPRINT_RTOL)."""
    jx, jy, _, stage_path = jax_stage
    _, x, y, classes = port_corpus
    assert len(classes) == 36 and x.shape == jx.shape == (36 * SPC, 30, 20)
    np.testing.assert_array_equal(y, jy)
    for c in range(len(classes)):
        got, want = x[y == c], jx[jy == c]
        dist = np.abs(got[:, None] - want[None]).max(axis=(2, 3))
        match = dist.argmin(axis=1)
        assert sorted(match) == list(range(len(want)))
        np.testing.assert_allclose(got, want[match], atol=1e-4, rtol=1e-4)
    with open(stage_path) as f:
        recorded = json.load(f)["__config__"]
    rel = parity.check_stage(recorded, parity.stage_config(_args(), x, 36),
                             parity.FINGERPRINT_RTOL, stage_path)
    assert max(rel) <= parity.FINGERPRINT_RTOL


def test_stage_refusal(jax_stage, port_corpus, tmp_path):
    """A stage file from another configuration is refused, naming both
    values: another field, another corpus shape, fingerprint sums outside
    rtol; and main() refuses before it trains anything."""
    _, x, _, _ = port_corpus
    with open(jax_stage[3]) as f:
        recorded = json.load(f)["__config__"]
    current = parity.stage_config(_args(), x, 36)
    for field, value in (("epochs", 100), ("distribution", "hard"),
                         ("n_samples", 13356)):
        with pytest.raises(SystemExit) as err:
            parity.check_stage({**recorded, field: value}, current, 1e-5, "f")
        assert field in str(err.value) and str(value) in str(err.value)
        assert str(current[field]) in str(err.value)
    s, a, shape = recorded["corpus_fingerprint"]
    for bad in ([s, a, [1, 30, 20]], [s * (1 + 1e-3), a, shape]):
        with pytest.raises(SystemExit, match="corpus_fingerprint"):
            parity.check_stage({**recorded, "corpus_fingerprint": bad},
                               current, 1e-5, "f")
    with pytest.raises(SystemExit, match="no __config__"):
        parity.check_stage(None, current, 1e-5, "f")
    work = port_corpus[0]
    with pytest.raises(SystemExit, match="epochs"):
        parity.main([*FLAGS[:2], "--epochs", "3", "--model_type",
                     "simple_gru", "--seed", "0", "--work_dir", work,
                     "--keras_stage", jax_stage[3], "--device", "cpu",
                     "--out", str(tmp_path / "never.json")])
    assert not os.path.exists(tmp_path / "never.json")


def test_torch_stage_end_to_end(jax_stage, port_corpus, tmp_path, capsys):
    """main() on the tiny corpus against the JAX tool's stage file, seeds
    0 and 1, one epoch: a finite accuracy a seed beside the stage's Keras
    accuracy, the torch-stage JSON, and the table's torch column."""
    work = port_corpus[0]
    out = str(tmp_path / "torch_stage.json")
    stage = parity.main([*FLAGS, "--seed", "0", "1", "--work_dir", work,
                         "--keras_stage", jax_stage[3], "--device", "cpu",
                         "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(stage))
    for seed in (0, 1):
        entry = stage["simple_gru"][str(seed)]
        assert 0.0 <= entry["acc"] <= 1.0
        assert entry["keras_acc"] == pytest.approx(0.5 + seed / 100)
    assert max(stage["__fingerprint_rel_diff__"]) <= parity.FINGERPRINT_RTOL
    printed = capsys.readouterr().out
    assert "| Keras (reference arch): **0.5050 ± 0.0071** | torch (port):" \
        in printed
