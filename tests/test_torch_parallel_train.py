"""`python -m tpu_speech_commands_torch.train --num_devices N` on the CPU:
two gloo ranks (spawned, one thread each) train on the features path, where
rank 0 extracts and caches the features and the other reads them.  Rank 0
writes the JAX file set, and after two epochs of sgd (lr 0.05) with the
GRU's dropout on (the global batch's mask), the final checkpoint is within
rtol 1e-5 / atol 1e-5 of the one-device run's (f32 sums of two shards in
another order), its epoch losses within the same.  The CLI refuses a mesh
that does not fit (`test_torch_train.py`)."""
import glob
import os

import numpy as np

from tpu_speech_commands_torch import train
from tpu_speech_commands_torch.checkpoints import load_checkpoint
from tpu_speech_commands_torch.data.synthetic import make_synthetic_dataset
from tpu_speech_commands_torch.params import pr
from tpu_speech_commands_torch.training.checkpoints import flatten_variables


def test_two_ranks_train_as_one_device(tmp_path):
    snap = pr.to_dict()
    data = str(tmp_path / "ds")
    make_synthetic_dataset(data, ["background", "left", "right"],
                           samples_per_class=6, seed=2)
    classes = tmp_path / "classes.txt"
    classes.write_text("background\nleft\nright\n")
    common = ["--model_type", "simple_gru", "--train_data_path", data,
              "--classes_path", str(classes), "--batch_size", "8",
              "--epochs", "2", "--optimizer", "sgd", "--learning_rate",
              "0.05", "--device", "cpu"]
    two = str(tmp_path / "two")
    assert train.main(train.build_parser().parse_args(
        common + ["--num_devices", "2", "--log_dir", two])) is None
    one = str(tmp_path / "one")
    trainer = train.main(train.build_parser().parse_args(
        common + ["--log_dir", one]))
    pr.override(snap)
    assert trainer.model.backbone.dropout_rate == 0.2
    assert {"trained_final.npz", "metrics.csv", "params.json",
            "classes.txt"} <= set(os.listdir(two))
    assert glob.glob(os.path.join(two, "ep001-*.npz"))
    got = flatten_variables(load_checkpoint(
        os.path.join(two, "trained_final.npz"))[0])
    want = flatten_variables(load_checkpoint(
        os.path.join(one, "trained_final.npz"))[0])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    losses = [np.loadtxt(os.path.join(d, "metrics.csv"), delimiter=",",
                         skiprows=1, usecols=(1, 3)) for d in (two, one)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5, atol=1e-5)
