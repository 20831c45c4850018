"""Training driver (counterpart of `tpu_speech_commands/training/trainer.py`,
its per-epoch path, `epochs_per_dispatch = 1`).

One device, one step a batch:
- the train step: (augmentation + frontend when training on raw audio) ->
  the model's plain PyTorch forward in training mode under autograd (the
  counterpart of the JAX step's XLA graph: the classifiers have no backward
  kernel, in either package) -> the masked mean loss and accuracy over the
  padded last batch -> the optimizer's update;
- the eval step: (frontend) -> the classifier kernel that serving uses
  (`serving.make_classifier`, on the card) -> summed loss and correct count.

The step's random draws come from the seed and the step: the augmentation's
from a host generator (the same on every device), dropout's from a
generator on the model's device.

Callbacks, as the JAX per-epoch fit: best-val_accuracy checkpoints with
keep-newest-5, ReduceLROnPlateau (x0.5 after 10 epochs, only without a
decay schedule, floor 1e-10), EarlyStopping (50), TerminateOnNaN, and a
`metrics.csv` with the JAX columns.  Not ported: the multi-epoch device
scan, the staging cache, meshes and TensorBoard (ROADMAP.md).
"""
from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..data.dataset import Dataset, batch_iterator
from ..device import DEFAULT_DEVICE, resolve_device
from ..losses import make_loss_fn
from ..models.factory import features_to_input
from ..serving import make_classifier
from .checkpoints import CheckpointManager

_DROPOUT, _PIPELINE = 0, 1  # the step's draw streams


def step_generator(seed: int, step: int, stream: int,
                   device="cpu") -> torch.Generator:
    """The generator of one train step's draws: `stream` 0 dropout (on the
    model's device), 1 the augmentation (on the host)."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) * 1_000_003 + int(step)) * 4 + stream)
                  % (1 << 62))
    return g


def make_train_step(model, loss_fn: Callable, optimizer,
                    device_pipeline: Callable | None = None,
                    compute_dtype=torch.float32, seed: int = 0):
    """(x, y, mask, step) -> (loss, accuracy) device scalars, after one
    update of `optimizer`'s parameters (the model's).

    device_pipeline (optional): (generator, x, train) -> model input, run
    first, e.g. augmentation + the frontend kernel on raw audio."""
    params = [p for p in model.parameters()]

    def train_step(x, y, mask, step: int):
        if device_pipeline is not None:
            x = device_pipeline(step_generator(seed, step, _PIPELINE), x, True)
        model.train()
        with torch.enable_grad():
            logits = model(x, compute_dtype=compute_dtype,
                           generator=step_generator(seed, step, _DROPOUT,
                                                    x.device))
            losses = loss_fn(y, logits)
            denom = torch.clamp(mask.sum(), min=1.0)
            loss = (losses * mask).sum() / denom
            grads = torch.autograd.grad(loss, params)
        acc = ((logits.argmax(-1) == y).float() * mask).sum() / denom
        optimizer.step(grads)
        return loss.detach(), acc.detach()

    return train_step


def make_eval_step(classifier, loss_fn: Callable,
                   device_pipeline: Callable | None = None):
    """(x, y, mask) -> summed (loss_sum, correct, count) device scalars,
    through `classifier` (a `serving.make_classifier` wrapper)."""

    def eval_step(x, y, mask):
        with torch.no_grad():
            if device_pipeline is not None:
                x = device_pipeline(None, x, False)
            logits = classifier(x)
            losses = loss_fn(y, logits)
            correct = (logits.argmax(-1) == y).float() * mask
            return torch.stack([(losses * mask).sum(), correct.sum(),
                                mask.sum()])

    return eval_step


def scale_lr(optimizer, factor: float, min_lr: float) -> None:
    """ReduceLROnPlateau's step on an injectable learning rate:
    lr <- max(lr * factor, min_lr)."""
    optimizer.learning_rate = max(optimizer.learning_rate * factor, min_lr)


@dataclass
class TrainerConfig:
    batch_size: int = 512
    epochs: int = 100
    log_dir: str = os.path.join("logs", "000")
    early_stopping_patience: int = 50
    plateau_patience: int = 10
    plateau_factor: float = 0.5
    plateau_min_lr: float = 1e-10
    use_plateau: bool = True  # disabled when a decay schedule is active
    max_keep: int = 5
    seed: int = 0


@dataclass
class EpochMetrics:
    epoch: int
    loss: float
    accuracy: float
    val_loss: float
    val_accuracy: float
    seconds: float
    lr: float | None = None


class Trainer:
    """The per-epoch training loop with the reference's callback semantics,
    on one device (the card unless the caller passes "cpu")."""

    def __init__(self, model, optimizer, model_type: str, num_classes: int,
                 config: TrainerConfig, background_bias: float | None = None,
                 checkpoint_meta: dict | None = None,
                 average_type: str | None = None,
                 device_pipeline: Callable | None = None,
                 device=DEFAULT_DEVICE, compute_dtype=torch.float32):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.model_type = model_type
        self.config = config
        self.device_pipeline = device_pipeline
        self.compute_dtype = compute_dtype
        self.checkpoint_meta = checkpoint_meta or {
            "model_type": model_type, "num_classes": num_classes}
        self.loss_fn = make_loss_fn(num_classes, background_bias)
        self.optimizer = optimizer
        if not optimizer.params:
            optimizer.bind(self.model.parameters())
        self.averager = None
        if average_type:
            from .averaging import WeightAverager

            self.averager = WeightAverager(average_type,
                                           self.model.parameters())
        self._train_step = make_train_step(self.model, self.loss_fn, optimizer,
                                           device_pipeline, compute_dtype,
                                           config.seed)
        self.step = optimizer.count
        self.history: list[EpochMetrics] = []

    def _batch(self, x, y, valid):
        if self.device_pipeline is None:  # raw audio goes to the pipeline
            x = features_to_input(x, self.model_type)
        mask = (np.arange(len(y)) < valid).astype(np.float32)
        return (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device),
                torch.from_numpy(np.asarray(y, np.int64)).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def run_epoch(self, ds: Dataset, epoch: int) -> dict:
        """One shuffled pass over ds; the metrics are summed on the device
        and read once at the end."""
        cfg = self.config
        totals = torch.zeros(2, device=self.device)
        n_batches = 0
        for x, y, valid in batch_iterator(ds, cfg.batch_size, shuffle=True,
                                          seed=cfg.seed + epoch):
            loss, acc = self._train_step(*self._batch(x, y, valid), self.step)
            totals += torch.stack([loss, acc])
            self.step += 1
            if self.averager is not None:
                self.averager.observe(self.step, self.model.parameters())
            n_batches += 1
        if n_batches == 0:
            return {"loss": 0.0, "accuracy": 0.0}
        loss, acc = (totals / n_batches).tolist()
        return {"loss": loss, "accuracy": acc}

    def eval_model(self):
        """The model evaluation and checkpoints use: the averaged parameters
        under EMA / SWA (the live BatchNorm statistics), else the model."""
        if self.averager is None or self.averager.average_type == "lookahead":
            return self.model
        model = copy.deepcopy(self.model)
        with torch.no_grad():
            for p, a in zip(model.parameters(), self.averager.avg_params):
                p.copy_(a)
        return model

    def evaluate(self, ds: Dataset) -> dict:
        """Mean loss and accuracy over ds through the classifier kernel."""
        model = self.eval_model()
        model.eval()
        classifier, _ = make_classifier(model, self.model_type,
                                        self.compute_dtype)
        eval_step = make_eval_step(classifier, self.loss_fn,
                                   self.device_pipeline)
        sums = torch.zeros(3, device=self.device)
        for x, y, valid in batch_iterator(ds, self.config.batch_size,
                                          shuffle=False):
            sums += eval_step(*self._batch(x, y, valid))
        loss_sum, correct, count = sums.tolist()
        count = max(count, 1.0)
        return {"loss": loss_sum / count, "accuracy": correct / count}

    def _current_lr(self):
        return self.optimizer.learning_rate

    def fit(self, train_ds: Dataset, val_ds: Dataset, verbose: bool = True):
        cfg = self.config
        os.makedirs(cfg.log_dir, exist_ok=True)
        ckpt = CheckpointManager(cfg.log_dir, max_keep=cfg.max_keep,
                                 meta=self.checkpoint_meta)
        logger = MetricsLogger(cfg.log_dir)
        best_val_acc = -np.inf
        epochs_since_best = 0
        plateau_wait = 0
        nan_terminated = False
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.time()
            train_metrics = self.run_epoch(train_ds, epoch)
            val_metrics = self.evaluate(val_ds)
            dt = time.time() - t0
            em = EpochMetrics(epoch=epoch, loss=train_metrics["loss"],
                              accuracy=train_metrics["accuracy"],
                              val_loss=val_metrics["loss"],
                              val_accuracy=val_metrics["accuracy"],
                              seconds=dt, lr=self._current_lr())
            self.history.append(em)
            logger.log(em)
            if verbose:
                print(f"Epoch {epoch}/{cfg.epochs} - {dt:.1f}s - "
                      f"loss: {em.loss:.4f} - accuracy: {em.accuracy:.4f} - "
                      f"val_loss: {em.val_loss:.4f} - "
                      f"val_accuracy: {em.val_accuracy:.4f}")
            # TerminateOnNaN
            if not np.isfinite(em.loss):
                print("NaN loss encountered — terminating training.")
                nan_terminated = True
                break
            # best checkpoint + keep-newest cleanup
            if em.val_accuracy > best_val_acc:
                best_val_acc = em.val_accuracy
                epochs_since_best = 0
                plateau_wait = 0
                ckpt.save_epoch(self.eval_model(), em)
            else:
                epochs_since_best += 1
                plateau_wait += 1
            # ReduceLROnPlateau, only without a decay schedule
            if cfg.use_plateau and plateau_wait >= cfg.plateau_patience:
                if self._current_lr() is not None:
                    scale_lr(self.optimizer, cfg.plateau_factor,
                             cfg.plateau_min_lr)
                    if verbose:
                        print(f"Reducing learning rate to "
                              f"{self._current_lr():.3e}")
                plateau_wait = 0
            # EarlyStopping
            if epochs_since_best >= cfg.early_stopping_patience:
                if verbose:
                    print(f"Early stopping at epoch {epoch}.")
                break
        return self._fit_finish(ckpt, logger, nan_terminated)

    def _fit_finish(self, ckpt, logger, nan_terminated: bool):
        if nan_terminated:
            # NaN weights would clobber a usable trained_final.npz
            print("Not writing trained_final.npz (NaN weights); use the "
                  "last best checkpoint (ep*.npz) instead.")
        else:
            ckpt.save_final(self.eval_model())
        logger.close()
        return self.history


class MetricsLogger:
    """The CSV metrics log, with the JAX package's columns."""

    def __init__(self, log_dir: str):
        self.csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv = open(self.csv_path, "a")
        if os.path.getsize(self.csv_path) == 0:
            self._csv.write("epoch,loss,accuracy,val_loss,val_accuracy,seconds,lr\n")

    def log(self, em: EpochMetrics):
        self._csv.write(
            f"{em.epoch},{em.loss:.6f},{em.accuracy:.6f},"
            f"{em.val_loss:.6f},{em.val_accuracy:.6f},{em.seconds:.3f},"
            f"{'' if em.lr is None else em.lr}\n")
        self._csv.flush()

    def close(self):
        self._csv.close()
