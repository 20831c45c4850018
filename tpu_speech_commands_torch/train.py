"""Train a speech-commands classifier (counterpart of the root `train.py`,
with the same flags and `--device`).

    python -m tpu_speech_commands_torch.train --model_type simple_gru \\
        --train_data_path ds --classes_path classes.txt --augment \\
        [--device cpu]

On the card (the default), `--augment` runs the augmentation and the
frontend kernel inside every train step; without it the features are
extracted once through the frontend kernel.  The classifier trains under
autograd over the port's plain modules, and the validation pass runs the
classifier kernel.  Differences from the JAX trainer: `--num_devices` takes
only 1, `--epochs_per_dispatch` is accepted and has no effect (one step a
batch, one checkpoint check an epoch), there is no TensorBoard log, and
`--dtype bfloat16` rounds the matmul and conv inputs to bf16 (f32
accumulation), as the scorer's bf16 paths do.
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
from .training import Trainer, TrainerConfig, restore_state
from .training.checkpoints import CheckpointManager
from .utils import ensure_background_first, get_classes


def main(args):
    """Returns the Trainer, after fit."""
    if args.num_devices not in (None, 1):
        raise ValueError(f"--num_devices {args.num_devices}: the port trains "
                         "on one device")
    device = resolve_device(args.device)
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
            pr, args.feature_type, args.batch_size, device)
        device_pipeline = make_audio_pipeline(frontend, args.model_type,
                                              noise_bank, device=device)
    else:
        frontend = MfccFrontend(pr, args.feature_type, device)
        if args.val_data_path:
            train_ds = get_dataset(args.train_data_path, class_names,
                                   frontend=frontend)
            val_ds = get_dataset(args.val_data_path, class_names,
                                 frontend=frontend)
        else:
            if not args.val_split > 0:
                raise ValueError("no val data split.")
            train_ds, val_ds = get_dataset(
                args.train_data_path, class_names, val_split=args.val_split,
                frontend=frontend)

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
        print(f"Load weights {args.weights_path}.")
    elif args.resume:
        newest = CheckpointManager(log_dir).latest()
        if newest:
            restore_state(model, newest, args.model_type)
            print(f"Resumed from {newest}.")
        else:
            print("No checkpoint to resume from; starting fresh.")

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
                      compute_dtype=compute_dtype)

    print(f"Train on {len(train_ds)} samples, val on {len(val_ds)} samples, "
          f"with batch size {args.batch_size} on {device}.")
    os.makedirs(log_dir, exist_ok=True)
    save_params(os.path.join(log_dir, "params.json"))
    with open(os.path.join(log_dir, "classes.txt"), "w") as f:
        f.write("\n".join(class_names) + "\n")

    history = trainer.fit(train_ds, val_ds)
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
                        help="only 1: the port trains on one device")
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
