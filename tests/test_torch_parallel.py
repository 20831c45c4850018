"""The port's parallelism (`tpu_speech_commands_torch/parallel/`, the mesh
paths of serving, evaluation and training) against the JAX package's, on
the CPU (the JAX side on the conftest's 8-device virtual mesh).

- Meshes: `make_mesh` / `make_hybrid_mesh` shapes and refusals equal the
  JAX ones case for case (the refusal text too), and `shard_spec` places
  every parameter of the three model families as the JAX `state_sharding`
  does on 2 x 2 and 2 x 3 meshes.
- The sharded scorer on four CPU shards: within 1e-5 of the JAX scorer
  (its plain XLA path) on `make_mesh(n_data=4)`, equal to the port's own
  unsharded scorer on each shard's rows (within 1e-6 on the whole batch),
  and a batch that does not divide raises the JAX message.
- Evaluation on four CPU shards, and `eval --num_devices 2`: accuracy and
  confusion matrix equal to the one-device result.
- The train steps of `dev/dryrun_multichip.py` on 4 gloo ranks on the CPU
  (one spawn): at data x model 2 x 2 with dropout 0 and a masked padded
  last batch, the loss, every parameter and the BatchNorm statistics
  within rtol 1e-5 / atol 1e-5 of the JAX step on `make_mesh(n_data=2,
  n_model=2)` (the bound of test_torch_train.py), with each rank holding a
  half of feature_dense's columns and of score_predict's rows; the hybrid
  steps bit-equal to their flat ones; the `--augment` step with dropout 0.5
  within 1e-6 (atol and rtol) of the port's one-device step; no rank loaded
  a JAX module.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_speech_commands import optim as jax_optim
from tpu_speech_commands.losses import make_loss_fn as jax_loss_fn
from tpu_speech_commands.models.cnn import SimpleCNN as JaxCNN
from tpu_speech_commands.models import init_model as jax_init_model
from tpu_speech_commands.parallel import batch_sharding, replicated
from tpu_speech_commands.parallel import make_hybrid_mesh as jax_hybrid_mesh
from tpu_speech_commands.parallel import make_mesh as jax_mesh
from tpu_speech_commands.parallel import batch_shards as jax_batch_shards
from tpu_speech_commands.parallel import param_spec as jax_param_spec
from tpu_speech_commands.parallel import state_sharding
from tpu_speech_commands.serving import make_batch_scorer as jax_scorer
from tpu_speech_commands.training import checkpoints as jax_ckpt
from tpu_speech_commands.training.trainer import TrainState
from tpu_speech_commands.training.trainer import make_train_step as jax_step
from tpu_speech_commands_torch import eval as port_eval
from tpu_speech_commands_torch.data.augment import make_audio_pipeline
from tpu_speech_commands_torch.data.dataset import Dataset
from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
from tpu_speech_commands_torch.dev import dryrun_multichip
from tpu_speech_commands_torch.evaluation import evaluate_accuracy
from tpu_speech_commands_torch.models import init_model
from tpu_speech_commands_torch.ops.training_frontend import \
    select_training_frontend
from tpu_speech_commands_torch.parallel import (batch_axes, batch_shards,
                                                make_hybrid_mesh, make_mesh,
                                                param_spec, shard_spec)
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.serving import make_batch_scorer, make_classifier
from tpu_speech_commands_torch.utils import get_classes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _restore_port_pr():
    snap = pr.to_dict()
    yield
    pr.override(snap)


def _outcome(build):
    try:
        return dict(build().shape)
    except ValueError as e:
        return str(e)


MESH_CASES = [
    (None, 1), (8, 1), (4, 2), (2, 4), (None, 2), (None, 8), (1, 1),
    (3, 3), (0, 1), (None, 16), (2, 0),
]


@pytest.mark.parametrize("n_data,n_model", MESH_CASES)
def test_make_mesh_matches_jax(n_data, n_model):
    want = _outcome(lambda: jax_mesh(n_data=n_data, n_model=n_model))
    got = _outcome(lambda: make_mesh(n_data=n_data, n_model=n_model,
                                     devices=CPU8))
    assert got == want


HYBRID_CASES = [
    (2, 2, 2), (2, None, 1), (2, None, 2), (4, 2, 1), (1, 8, 1),
    (4, 4, 1), (2, 2, 4), (0, 2, 1), (3, None, 1),
]


@pytest.mark.parametrize("n_replica,n_data,n_model", HYBRID_CASES)
def test_make_hybrid_mesh_matches_jax(n_replica, n_data, n_model):
    want = _outcome(lambda: jax_hybrid_mesh(n_replica, n_data, n_model))
    got = _outcome(lambda: make_hybrid_mesh(n_replica, n_data, n_model,
                                            devices=CPU8))
    assert got == want


class _SliceDevice:
    def __init__(self, i):
        self.id = i
        self.slice_index = i // 4


def test_hybrid_multislice_refusal_matches_jax():
    devs = [_SliceDevice(i) for i in range(8)]
    with pytest.raises(ValueError) as want:
        jax_hybrid_mesh(n_replica=2, n_data=1, n_model=2, devices=devs)
    with pytest.raises(ValueError) as got:
        make_hybrid_mesh(n_replica=2, n_data=1, n_model=2, devices=devs)
    assert str(got.value) == str(want.value)
    # an exact cover groups the devices by slice, one slice a replica row
    mesh = make_hybrid_mesh(2, 2, 2, devices=devs[4:] + devs[:4])
    assert [d.slice_index for d in mesh.devices[0].reshape(-1)] == [0] * 4


def test_batch_helpers_match_jax():
    for want, got in ((jax_mesh(n_data=8), make_mesh(8, devices=CPU8)),
                      (jax_hybrid_mesh(2, 2, 2),
                       make_hybrid_mesh(2, 2, 2, devices=CPU8))):
        assert batch_axes(got) == tuple(a for a in want.axis_names
                                        if a != "model")
        assert batch_shards(got) == jax_batch_shards(want)
    assert batch_shards(None) == 1
    devs = [object() for _ in range(8)]
    mesh = make_hybrid_mesh(2, 2, 2, devices=devs)
    assert mesh.batch_devices() == devs[::2]  # model index 0


PATHS = [("params", "feature_dense", "kernel"), ("params", "feature_dense",
                                                 "bias"),
         ("params", "score_predict", "kernel"), ("params", "score_predict",
                                                 "bias"),
         ("params", "block1", "conv", "kernel"), ("batch_stats", "block1",
                                                  "bn", "mean"),
         ("params", "backbone", "gru_unit_0", "kernel")]


@pytest.mark.parametrize("path", PATHS, ids=".".join)
def test_param_spec_matches_jax(path):
    assert param_spec(path) == tuple(jax_param_spec(path, None))
    assert param_spec(".".join(path[1:])) == tuple(jax_param_spec(path, None))


@pytest.mark.parametrize("model_type", ["simple_cnn", "simple_gru",
                                        "simple_cnn_lite"])
@pytest.mark.parametrize("n_model", [2, 3])
def test_shard_spec_matches_state_sharding(model_type, n_model):
    """Every parameter placed as the JAX state_sharding places it, with the
    replication fallback where a dimension does not divide (3 ranks)."""
    _, variables = jax_init_model(model_type, 5, jax.random.PRNGKey(0))
    shardings = jax.tree_util.tree_leaves(
        state_sharding(variables, jax_mesh(n_data=2, n_model=n_model)),
        is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))
    port_mesh = make_mesh(2, n_model, devices=["cpu"] * 6)
    specs = {}
    for (path, leaf), sharding in zip(
            jax.tree_util.tree_leaves_with_path(variables), shardings):
        key = ".".join(k.key for k in path[1:])
        specs[key] = shard_spec(key, leaf.shape, port_mesh)
        assert specs[key] == tuple(sharding.spec), key
    split = sorted(k for k, s in specs.items() if s)
    if model_type == "simple_gru":  # 48 rows divide by 2 and by 3
        assert split == ["score_predict.kernel"]
    elif n_model == 2:
        assert split == ["feature_dense.bias", "feature_dense.kernel",
                         "score_predict.kernel"]
    else:  # 128 does not divide by 3: the pair stays replicated
        assert split == []


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(7)
    return (0.1 * rng.standard_normal((8, 16000))).astype(np.float32)


@pytest.mark.parametrize("model_type", ["simple_gru", "simple_cnn"])
def test_sharded_scorer_matches_jax_and_one_device(clips, model_type):
    path = os.path.join(REPO, "pretrained", f"direction_{model_type}.npz")
    mesh = make_mesh(devices=["cpu"] * 4)
    scorer = make_batch_scorer(path, "cpu", mesh=mesh)
    assert scorer.paths["parallel"] == "shards x4"
    got = scorer(clips).numpy()
    want = np.asarray(jax_scorer(path, use_pallas=False,
                                 mesh=jax_mesh(n_data=4))(jnp.asarray(clips)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the one-device scorer on each shard's rows, bit for bit; on the whole
    # batch within 1e-6: the CPU's plain matmuls and convs may sum a row in
    # another order at another batch size (the card's kernels do not)
    one = make_batch_scorer(path, "cpu")
    np.testing.assert_array_equal(
        got, np.concatenate([one(part).numpy() for part in np.split(clips, 4)]))
    np.testing.assert_allclose(got, one(clips).numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError) as err:
        scorer(clips[:6])
    with pytest.raises(ValueError) as jax_err:
        jax_scorer(path, use_pallas=False, mesh=jax_mesh(n_data=4))(
            jnp.asarray(clips[:6]))
    assert str(err.value) == str(jax_err.value)


def test_sharded_evaluation_equals_one_device():
    rng = np.random.default_rng(3)
    ds = Dataset((2 * rng.standard_normal((37, 30, 20))).astype(np.float32),
                 rng.integers(0, 5, 37).astype(np.int32))
    model, _ = init_model("simple_gru", 5, seed=1)
    classifier, _ = make_classifier(model, "simple_gru")
    names = [f"c{i}" for i in range(5)]
    kw = dict(batch_size=10, save_plot=False, verbose=False)
    want = evaluate_accuracy(classifier, ds, "simple_gru", names, **kw)
    got = evaluate_accuracy(classifier, ds, "simple_gru", names,
                            mesh=make_mesh(devices=["cpu"] * 4), **kw)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].sum() == 37


def test_eval_cli_on_two_shards_equals_one_device(tmp_path):
    """eval --num_devices 2 (two CPU shards) against eval on one device."""
    classes = os.path.join(REPO, "configs", "direction_classes.txt")
    data = str(tmp_path / "ds")
    make_synthetic_dataset(data, get_classes(classes), samples_per_class=3,
                           seed=4)
    argv = ["--model_path", os.path.join(REPO, "pretrained",
                                         "direction_simple_gru.npz"),
            "--dataset_path", data, "--classes_path", classes,
            "--device", "cpu", "--batch_size", "4",
            "--output_path", str(tmp_path / "result")]
    want = port_eval.main(port_eval.build_parser().parse_args(argv))
    got = port_eval.main(port_eval.build_parser().parse_args(
        argv + ["--num_devices", "2"]))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].sum() == 15


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """dev/dryrun_multichip on 4 gloo ranks on the CPU: (summary, out dir)."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    return dryrun_multichip.run(["cpu"] * 4, "gloo", out), out


def _jax_tp_step(init_path, x, y, mask):
    """The JAX train step on make_mesh(n_data=2, n_model=2) from the port's
    init checkpoint: sgd at the dry run's rate, dropout 0."""
    model = JaxCNN(num_classes=dryrun_multichip.C, dropout_rate=0.0)
    variables, _ = jax_ckpt.load_checkpoint(init_path)
    tx = jax_optim.get_optimizer("sgd", dryrun_multichip.STEP_LR,
                                 decay_type=None, injectable=True)
    state = TrainState.create(apply_fn=model.apply, params=variables["params"],
                              tx=tx, batch_stats=variables["batch_stats"])
    mesh = jax_mesh(n_data=2, n_model=2)
    data, st = batch_sharding(mesh), state_sharding(state, mesh)
    step = jax.jit(jax_step(model, jax_loss_fn(dryrun_multichip.C), True),
                   in_shardings=(st, data, data, data, replicated(mesh)),
                   out_shardings=(st, replicated(mesh)))
    state, metrics = step(jax.device_put(state, st),
                          *(jax.device_put(jnp.asarray(a), data)
                            for a in (x, y.astype(np.int32), mask)),
                          jax.random.PRNGKey(1))
    assert state.params["feature_dense"]["kernel"].sharding.spec == \
        jax.sharding.PartitionSpec(None, "model")
    return float(metrics["loss"]), jax_ckpt.flatten_variables(
        jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))


def test_tp_step_matches_jax(dryrun):
    _, out = dryrun
    x, y, mask = dryrun_multichip.feature_batch(8)
    want_loss, want = _jax_tp_step(os.path.join(out, "init_cnn.npz"), x, y,
                                   mask)
    got = dict(np.load(os.path.join(out, "step_data_x_model.npz")))
    np.testing.assert_allclose(float(got.pop("loss")), want_loss,
                               rtol=1e-5, atol=1e-5)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    init, _ = jax_ckpt.load_checkpoint(os.path.join(out, "init_cnn.npz"))
    assert not np.allclose(got["params/feature_dense/kernel"],
                           init["params"]["feature_dense"]["kernel"])


def test_each_rank_holds_its_shard(dryrun):
    summary, _ = dryrun
    assert summary["layouts"]["data_x_model"] == (1, 2, 2)
    for rank in summary["ranks"]:
        shards = rank["shards"]
        assert shards["data_x_model"] == {"feature_dense": [256, 64],
                                          "score_predict": [64, 5]}
        assert shards["hybrid"] == shards["data_x_model"]
        assert shards["data"] == {"feature_dense": [256, 128],
                                  "score_predict": [128, 5]}
        assert rank["foreign_modules"] == []


@pytest.mark.parametrize("flat,hybrid", dryrun_multichip.BIT_EQUAL)
def test_hybrid_step_bit_equal_to_flat(dryrun, flat, hybrid):
    _, out = dryrun
    a = np.load(os.path.join(out, f"step_{flat}.npz"))
    b = np.load(os.path.join(out, f"step_{hybrid}.npz"))
    assert a.files == b.files
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_dropout_step_on_four_ranks_equals_one_device(dryrun):
    """The --augment step with dropout 0.5 (global mask and draws) and a
    masked padded last batch, 4 ranks against the port's 1-rank step."""
    _, out = dryrun
    audio, y, mask, noise = dryrun_multichip.audio_batch(8)
    frontend, kind = select_training_frontend(pr, "mfcc", 8, "cpu", False)
    pipe = make_audio_pipeline(frontend, "simple_cnn", noise, device="cpu")
    loss, model = dryrun_multichip.one_step(
        dryrun_multichip.init_state("simple_cnn"), audio, y, mask, "cpu",
        pipeline=pipe)
    want = dryrun_multichip.flat_state(loss, model)
    got = dict(np.load(os.path.join(out, "step_augment.npz")))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    assert model.dropout_rate == 0.5


def test_dryrun_summary(dryrun):
    summary, out = dryrun
    assert summary["frontend"] == "torch+ranks"
    assert summary["serving"]["parallel"] == "shards x4"
    assert summary["backend"] == "gloo"
    for key in ("loss", "epoch_loss", "audio_pipeline_loss", "gru_loss"):
        assert np.isfinite(summary[key])
    with open(os.path.join(out, "cnn", "metrics.csv")) as f:
        assert len(f.read().splitlines()) == 2  # header and one epoch
    assert os.path.exists(os.path.join(out, "gru", "trained_final.npz"))
    assert [r["device"] for r in summary["ranks"]] == ["cpu"] * 4
