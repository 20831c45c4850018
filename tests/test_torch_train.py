"""The port's training (`tpu_speech_commands_torch/training/`, `train.py`,
`models/` in training mode) against the JAX package's, on the CPU.

- Three train steps from one JAX init, written with JAX's save_checkpoint
  and loaded into the port through the `.npz`, on identical batches (the
  last with masked pad rows) with dropout 0: with sgd at lr 0.05, the
  losses and every parameter within rtol 1e-5 / atol 1e-5 in f32 (the same
  f32 math in another order), and for simple_cnn the BatchNorm running
  statistics too; with adam at lr 1e-3 (the trainer's default) the losses
  within the same bound.  The parameters are held under sgd, where their
  error is the gradients' times the learning rate: adam divides each
  gradient by its own running magnitude, so an f32 rounding difference in a
  near-zero gradient (6e-7 against a mean of 0.049 in simple_cnn's block 3)
  becomes a difference of a whole step (7e-5 after three), which says
  nothing of the port.  Adam itself is held to optax in test_torch_optim.py.
  simple_gru, simple_lstm, simple_cnn.
- One bf16 step: the loss within 5e-2 (the JAX model runs its activations
  in bf16, the port rounds the matmul inputs only).
- The checkpoint round trip both ways, scores within 1e-5, tensors equal.
- `fit` for 2 epochs (`train.main` on the CPU) writes the JAX file set.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_speech_commands import optim as jax_optim
from tpu_speech_commands.losses import make_loss_fn as jax_loss_fn
from tpu_speech_commands.models import init_model as jax_init_model
from tpu_speech_commands.models.cnn import SimpleCNN as JaxCNN
from tpu_speech_commands.models.rnn import SimpleGRU as JaxGRU
from tpu_speech_commands.models.rnn import SimpleLSTM as JaxLSTM
from tpu_speech_commands.training import checkpoints as jax_ckpt
from tpu_speech_commands.training.trainer import MetricsLogger as JaxLogger
from tpu_speech_commands.training.trainer import TrainState
from tpu_speech_commands.training.trainer import make_train_step as jax_step
from tpu_speech_commands_torch import train
from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
from tpu_speech_commands_torch.export.inference_loader import load_native
from tpu_speech_commands_torch.losses import make_loss_fn
from tpu_speech_commands_torch.models import get_model, init_model
from tpu_speech_commands_torch.optim import get_optimizer
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.training import Trainer, TrainerConfig
from tpu_speech_commands_torch.training.checkpoints import (flatten_variables,
                                                            restore_state,
                                                            save_checkpoint)
from tpu_speech_commands_torch.training.trainer import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODELS = {"simple_gru": JaxGRU, "simple_lstm": JaxLSTM,
              "simple_cnn": JaxCNN}
B, C = 8, 5


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _batches(model_type, n=3, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, 30, 20, 1) if model_type == "simple_cnn" else (B, 30, 20)
    out = []
    for i in range(n):
        mask = np.ones(B, np.float32)
        if i == n - 1:
            mask[-2:] = 0.0  # a padded last batch
        out.append(((2 * rng.standard_normal(shape)).astype(np.float32),
                    rng.integers(0, C, B).astype(np.int32), mask))
    return out


OPTIMIZERS = {"sgd": 0.05, "adam": 1e-3}  # name: learning rate


def _jax_run(model_type, batches, path, dtype=jnp.float32, optimizer="adam"):
    """JAX init written to `path`, then len(batches) jitted train steps;
    returns (losses, state)."""
    model = JAX_MODELS[model_type](num_classes=C, dropout_rate=0.0, dtype=dtype)
    x0 = jnp.zeros(batches[0][0].shape, jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(3)}, x0, train=False)
    tx = jax_optim.get_optimizer(optimizer, OPTIMIZERS[optimizer],
                                 decay_type=None, injectable=True)
    state = TrainState.create(apply_fn=model.apply, params=variables["params"],
                              tx=tx, batch_stats=variables.get("batch_stats"))
    jax_ckpt.save_checkpoint(path, state, {"model_type": model_type,
                                           "num_classes": C})
    step = jax.jit(jax_step(model, jax_loss_fn(C), state.batch_stats is not None))
    losses = []
    for x, y, mask in batches:
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(mask), jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    return losses, state


def _port_run(model_type, batches, path, compute_dtype=torch.float32,
              optimizer="adam"):
    model = get_model(model_type, C, dropout_rate=0.0)
    restore_state(model, path, model_type)
    opt = get_optimizer(optimizer, OPTIMIZERS[optimizer], decay_type=None,
                        injectable=True, params=model.parameters())
    step = make_train_step(model, make_loss_fn(C), opt,
                           compute_dtype=compute_dtype)
    losses = []
    for i, (x, y, mask) in enumerate(batches):
        loss, _ = step(torch.tensor(x), torch.tensor(y, dtype=torch.int64),
                       torch.tensor(mask), i)
        losses.append(float(loss))
    return losses, model


@pytest.mark.parametrize("model_type", sorted(JAX_MODELS))
def test_three_train_steps_match_jax(model_type, tmp_path):
    batches = _batches(model_type)
    path = str(tmp_path / "init.npz")
    want_losses, _ = _jax_run(model_type, batches, path)
    got_losses, _ = _port_run(model_type, batches, path)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-5)
    want_losses, state = _jax_run(model_type, batches, path, optimizer="sgd")
    got_losses, model = _port_run(model_type, batches, path, optimizer="sgd")
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-5)
    want = jax_ckpt.flatten_variables(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    got = flatten_variables(model.variables())
    assert set(got) == set(want)
    assert any(k.startswith("batch_stats") for k in got) == (
        model_type == "simple_cnn")
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    # the parameters moved, and so did the BatchNorm statistics
    init = flatten_variables(get_model(model_type, C).variables())
    assert not np.allclose(got["params/score_predict/kernel"],
                           jax_ckpt.load_checkpoint(path)[0]["params"]
                           ["score_predict"]["kernel"])
    if model_type == "simple_cnn":
        assert not np.allclose(got["batch_stats/block2/bn/var"],
                               init["batch_stats/block2/bn/var"])


def test_bf16_loss_matches_jax(tmp_path):
    batches = _batches("simple_gru", n=1, seed=5)
    path = str(tmp_path / "init.npz")
    want, _ = _jax_run("simple_gru", batches, path, jnp.bfloat16)
    got, _ = _port_run("simple_gru", batches, path, torch.bfloat16)
    assert abs(got[0] - want[0]) <= 5e-2


def test_checkpoint_round_trip_port_to_jax(tmp_path):
    """A few port train steps, written by the port; read by the JAX package
    (load_checkpoint + restore_state) and by the port's load_native: the
    same tensors, and the same scores within 1e-5."""
    batches = _batches("simple_cnn", seed=9)
    init = str(tmp_path / "init.npz")
    _jax_run("simple_cnn", batches[:1], init)
    _, model = _port_run("simple_cnn", batches, init)
    meta = {"model_type": "simple_cnn", "num_classes": C,
            "params": pr.to_dict(), "feature_type": "mfcc"}
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, model, meta)
    variables, got_meta = jax_ckpt.load_checkpoint(path)
    assert got_meta == meta
    jmodel, jvars = jax_init_model("simple_cnn", C, jax.random.PRNGKey(0))
    state = TrainState.create(apply_fn=jmodel.apply, params=jvars["params"],
                              tx=jax_optim.get_optimizer("adam", 1e-3),
                              batch_stats=jvars["batch_stats"])
    state = jax_ckpt.restore_state(state, path)
    restored = jax_ckpt.flatten_variables(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    for key, value in flatten_variables(model.variables()).items():
        np.testing.assert_array_equal(restored[key], value)
    x = batches[0][0]
    logits = jmodel.apply({"params": state.params,
                           "batch_stats": state.batch_stats}, jnp.asarray(x))
    want = np.asarray(jax.nn.softmax(logits, -1))
    got = load_native(path, "cpu")(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_checkpoint_round_trip_jax_to_port(tmp_path):
    """A JAX init_model written by JAX's save_checkpoint restores into the
    port's trainer tensor for tensor; a checkpoint of another model is
    refused."""
    for model_type in ("simple_lstm", "simple_cnn_lite"):
        _, jvars = jax_init_model(model_type, C, jax.random.PRNGKey(2))
        path = str(tmp_path / f"{model_type}.npz")
        jax_ckpt.save_checkpoint(path, jvars, {"model_type": model_type})
        model, _ = init_model(model_type, C, seed=1)
        restore_state(model, path, model_type)
        trainer = Trainer(model, get_optimizer("adam", 1e-3), model_type, C,
                          TrainerConfig(), device="cpu")
        want = jax_ckpt.flatten_variables(jax.tree_util.tree_map(np.asarray,
                                                                 jvars))
        got = flatten_variables(trainer.model.variables())
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError):
        restore_state(get_model("simple_gru", C), path, "simple_gru")


def test_fit_writes_the_jax_file_set(tmp_path):
    """train.main on the CPU, 2 epochs on raw audio with --augment: the
    epoch checkpoints, trained_final.npz, metrics.csv (the JAX columns),
    params.json and classes.txt; the final checkpoint loads and scores."""
    data = str(tmp_path / "ds")
    make_synthetic_dataset(data, ["background", "left", "right"],
                           samples_per_class=6, seed=1)
    classes = tmp_path / "classes.txt"
    classes.write_text("background\nleft\nright\n")
    log_dir = str(tmp_path / "logs")
    args = train.build_parser().parse_args([
        "--model_type", "simple_gru", "--train_data_path", data,
        "--classes_path", str(classes), "--batch_size", "8", "--epochs", "2",
        "--augment", "--log_dir", log_dir, "--device", "cpu"])
    trainer = train.main(args)
    assert len(trainer.history) == 2
    assert all(np.isfinite(h.loss) for h in trainer.history)
    names = sorted(os.listdir(log_dir))
    assert {"trained_final.npz", "metrics.csv", "params.json",
            "classes.txt"} <= set(names)
    assert glob.glob(os.path.join(log_dir, "ep001-loss*-val_accuracy*.npz"))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    JaxLogger(str(jax_dir), tensorboard=False).close()
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == (jax_dir / "metrics.csv").read_text().strip()
    assert len(lines) == 3 and lines[1].startswith("1,")
    assert (tmp_path / "logs" / "classes.txt").read_text() == \
        "background\nleft\nright\n"
    predictor = load_native(os.path.join(log_dir, "trained_final.npz"), "cpu")
    assert predictor.classes == ["background", "left", "right"]
    scores = predictor(np.zeros((2, 30, 20), np.float32))
    assert scores.shape == (2, 3) and torch.isfinite(scores).all()
    with pytest.raises(ValueError, match="one device"):
        train.main(train.build_parser().parse_args(
            ["--train_data_path", data, "--classes_path", str(classes),
             "--num_devices", "2", "--device", "cpu"]))


@pytest.mark.parametrize("average_type", ["ema", "swa", "lookahead"])
def test_weight_averaging_matches_jax(average_type):
    """13 steps of observe() on a fixed parameter sequence: the averaged
    (or, for lookahead, the slow and the reset fast) weights within atol
    1e-6 of the JAX WeightAverager's (the same f32 arithmetic)."""
    from tpu_speech_commands.training.averaging import WeightAverager as JaxAvg
    from tpu_speech_commands_torch.training.averaging import WeightAverager

    rng = np.random.default_rng(8)
    start = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    jax_avg = JaxAvg(average_type, [jnp.asarray(a) for a in start],
                     swa_period=3)
    params = [torch.tensor(a) for a in start]
    avg = WeightAverager(average_type, params, swa_period=3)
    jp = [jnp.asarray(a) for a in start]
    for step in range(1, 14):
        delta = [rng.standard_normal(a.shape).astype(np.float32) for a in start]
        jp = [p + d for p, d in zip(jp, delta)]
        for p, d in zip(params, delta):
            p += torch.tensor(d)
        synced = jax_avg.observe(step, jp)
        if synced is not None:
            jp = list(synced)
        assert avg.observe(step, params) == (synced is not None)
        for got, want in zip(avg.avg_params, jax_avg.params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        for got, want in zip(params, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError):
        WeightAverager("polyak", params)
