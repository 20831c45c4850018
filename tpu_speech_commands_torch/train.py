"""Train a speech-commands classifier (counterpart of the root `train.py`,
with the same flags and `--device`).

    python -m tpu_speech_commands_torch.train --model_type simple_gru \\
        --train_data_path ds --classes_path classes.txt --augment \\
        [--device cpu]

On the card (the default), `--augment` runs the augmentation and the
frontend kernel inside every train step; without it the features are
extracted once through the frontend kernel.  The classifier trains under
autograd over the port's plain modules, and the validation pass runs the
classifier kernel.

`--num_devices N` trains on N devices on the 'data' axis, one process a
device (`parallel/launch.py`: N ranks started with `spawn`, NCCL between
distinct cards, gloo on the CPU); the default, as in the JAX trainer, is
every visible card (the one card `--device cuda:<i>` names; one device for
`--device cpu`, where N gloo ranks share the CPU).  A mesh larger than the
devices raises the JAX ValueError.  Under `torchrun` (WORLD_SIZE set) each
process is one rank of that group.  Rank 0 prints and writes the log
directory.

Differences from the JAX trainer: `--epochs_per_dispatch` is accepted and
has no effect (one step a batch, one checkpoint check an epoch), and
`--dtype bfloat16` rounds the matmul and conv inputs to bf16 (f32
accumulation), as the scorer's bf16 paths do.  The log directory gets the
JAX trainer's TensorBoard scalars where TensorFlow or tensorboard imports
(`training.trainer.MetricsLogger`; the card's machine has neither, and
there metrics.csv is the log).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data.dataset import get_audio_dataset, get_dataset
from .device import DEFAULT_DEVICE, resolve_device
from .models import MODEL_TYPES, init_model
from .ops.frontend_kernel import MfccFrontend
from .optim import get_optimizer
from .params import inject_params, pr, save_params
from .parallel import batch_shards, init_process_mesh, make_mesh
from .training import Trainer, TrainerConfig, restore_state
from .training.checkpoints import CheckpointManager
from .utils import ensure_background_first, get_classes


def train_mesh(args):
    """The ('data', 'model') mesh of --num_devices over the devices --device
    names: every visible card for "cuda", that card alone for "cuda:<i>"
    without --num_devices, N copies of the CPU for "cpu" (N gloo ranks);
    ValueError when it does not fit."""
    device = torch.device(args.device)
    if device.type == "cpu":
        devices = ["cpu"] * (args.num_devices or 1)
    else:
        resolve_device(device)
        devices = None  # every visible card
        if device.index is not None and args.num_devices is None:
            devices = [device]
    return make_mesh(n_data=args.num_devices, devices=devices)


def main(args):
    """Returns the Trainer, after fit (None in the parent of spawned
    ranks)."""
    mesh = train_mesh(args)
    devices = [str(d) for d in mesh.batch_devices()]
    if batch_shards(mesh) == 1:
        return fit(args, devices[0])
    from .parallel import launch

    if "WORLD_SIZE" in os.environ:  # one rank of a torchrun group
        rank, device = launch.init_from_env(devices)
        return fit_rank(rank, device, args, len(devices))
    if mesh.devices.flat[0].type == "cuda":
        # one nvcc build in the parent, not one in every rank
        from .ops import _build

        _build.load_library()
    launch.launch(fit_rank, devices, args=(args, len(devices)))
    return None


def fit_rank(rank: int, device, args, n_data: int):
    """One rank of `main`'s data-parallel run (a spawned process)."""
    del rank
    return fit(args, device, init_process_mesh(1, n_data, 1, device))


def fit(args, device, mesh=None):
    """Train on one device, or as one rank of a process `mesh`; returns the
    Trainer, after fit."""
    device = resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    log_dir = args.log_dir
    class_names = get_classes(args.classes_path)
    ensure_background_first(class_names)
    num_classes = len(class_names)
    if args.params_path:
        inject_params(args.params_path)

    device_pipeline = None
    if args.augment:
        # raw audio: augmentation and the frontend run inside the train
        # step; the background class doubles as the noise bank
        from .data.augment import make_audio_pipeline
        from .ops.training_frontend import select_training_frontend

        if args.val_data_path:
            train_ds = get_audio_dataset(args.train_data_path, class_names)
            val_ds = get_audio_dataset(args.val_data_path, class_names)
        else:
            if not args.val_split > 0:
                raise ValueError("no val data split.")
            train_ds, val_ds = get_audio_dataset(
                args.train_data_path, class_names, val_split=args.val_split)
        noise_bank = train_ds.x[train_ds.y == 0]
        if len(noise_bank) == 0:
            noise_bank = np.zeros((1, pr.max_samples), np.float32)
        frontend, _ = select_training_frontend(
            pr, args.feature_type, args.batch_size, device, verbose=writer,
            mesh=mesh)
        device_pipeline = make_audio_pipeline(frontend, args.model_type,
                                              noise_bank, device=device,
                                              mesh=mesh)
    else:
        frontend = MfccFrontend(pr, args.feature_type, device)

        def load():
            if args.val_data_path:
                return (get_dataset(args.train_data_path, class_names,
                                    frontend=frontend),
                        get_dataset(args.val_data_path, class_names,
                                    frontend=frontend))
            if not args.val_split > 0:
                raise ValueError("no val data split.")
            return get_dataset(args.train_data_path, class_names,
                               val_split=args.val_split, frontend=frontend)

        if mesh is not None:
            # rank 0 extracts and caches the features, then every rank reads
            # the cache: a first extraction and the cache order the samples
            # differently, and every rank must hold the same rows
            if writer:
                load()
            torch.distributed.barrier()
        train_ds, val_ds = load()

    # ceil: the padded final batch is a step too
    steps_per_epoch = max(1, -(-len(train_ds) // args.batch_size))
    optimizer = get_optimizer(
        args.optimizer, args.learning_rate, average_type=args.average_type,
        decay_type=args.decay_type, decay_steps=steps_per_epoch * args.epochs,
        injectable=args.decay_type is None)
    if args.background_bias is not None and not 0 < args.background_bias < 1:
        raise ValueError("background bias should between 0 and 1")

    model, _ = init_model(args.model_type, num_classes, args.seed,
                          num_layers=args.num_layers,
                          bn_momentum=args.bn_momentum)
    if args.weights_path:
        restore_state(model, args.weights_path, args.model_type)
        if writer:
            print(f"Load weights {args.weights_path}.")
    elif args.resume:
        newest = CheckpointManager(log_dir).latest()
        if newest:
            restore_state(model, newest, args.model_type)
        if writer:
            print(f"Resumed from {newest}." if newest else
                  "No checkpoint to resume from; starting fresh.")

    config = TrainerConfig(batch_size=args.batch_size, epochs=args.epochs,
                           log_dir=log_dir, use_plateau=args.decay_type is None,
                           seed=args.seed)
    trainer_meta = {
        "model_type": args.model_type,
        "num_classes": num_classes,
        "classes": class_names,
        "params": pr.to_dict(),
        "feature_type": args.feature_type,
    }
    if args.num_layers != 1:
        trainer_meta["num_layers"] = args.num_layers
    compute_dtype = {"float32": torch.float32,
                     "bfloat16": torch.bfloat16}[args.dtype]
    trainer = Trainer(model, optimizer, args.model_type, num_classes, config,
                      background_bias=args.background_bias,
                      checkpoint_meta=trainer_meta,
                      average_type=args.average_type,
                      device_pipeline=device_pipeline, device=device,
                      compute_dtype=compute_dtype, mesh=mesh)

    if writer:
        where = device if mesh is None else f"mesh {mesh.shape}"
        print(f"Train on {len(train_ds)} samples, val on {len(val_ds)} "
              f"samples, with batch size {args.batch_size} on {where}.")
        os.makedirs(log_dir, exist_ok=True)
        save_params(os.path.join(log_dir, "params.json"))
        with open(os.path.join(log_dir, "classes.txt"), "w") as f:
            f.write("\n".join(class_names) + "\n")

    history = trainer.fit(train_ds, val_ds)
    if writer:
        best = max((h.val_accuracy for h in history), default=0.0)
        print(f"Best val_accuracy: {best:.4f}")
    return trainer


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_type", type=str, default="simple_cnn",
                        choices=list(MODEL_TYPES),
                        help="classifier model type, default=%(default)s")
    parser.add_argument("--weights_path", type=str, default=None,
                        help="pretrained checkpoint (.npz) for fine tune")
    parser.add_argument("--train_data_path", type=str, required=True)
    parser.add_argument("--val_data_path", type=str, default=None)
    parser.add_argument("--val_split", type=float, default=0.15)
    parser.add_argument("--classes_path", type=str, required=True)
    parser.add_argument("--params_path", type=str, default=None)
    parser.add_argument("--background_bias", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "rmsprop", "sgd"])
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--decay_type", type=str, default=None,
                        choices=[None, "cosine", "exponential", "polynomial",
                                 "piecewise_constant"])
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--average_type", type=str, default=None,
                        choices=[None, "ema", "swa", "lookahead"],
                        help="weight averaging")
    parser.add_argument("--feature_type", type=str, default="mfcc",
                        choices=["mfcc", "bark"])
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="matmul input dtype (params stay fp32)")
    parser.add_argument("--augment", action="store_true",
                        help="train on raw audio with random gain/shift/"
                             "noise-SNR and the frontend inside the step")
    parser.add_argument("--num_layers", type=int, default=1,
                        help="stacked RNN layers (RNN model types only)")
    parser.add_argument("--bn_momentum", type=float, default=0.99,
                        help="BatchNorm running-stats momentum")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="devices on the data axis, one rank each "
                             "(default: every visible card; 1 on the CPU)")
    parser.add_argument("--log_dir", type=str, default=os.path.join("logs", "000"))
    parser.add_argument("--resume", action="store_true",
                        help="resume weights from the newest checkpoint in log_dir")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs_per_dispatch", type=int, default=10,
                        help="accepted for the JAX trainer's command lines; "
                             "no effect (one step a batch)")
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
