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
decay schedule, floor 1e-10), EarlyStopping (50), TerminateOnNaN, a
`metrics.csv` with the JAX columns and, with `log_tensorboard`, the JAX
logger's TensorBoard scalars.  Not ported: the multi-epoch device scan and
the staging cache (ROADMAP.md).

Under a process mesh (`parallel.ProcessMesh`, one rank a device: the
counterpart of the JAX trainer's mesh-sharded step) every rank runs the
same `batch_iterator` and takes its rows of each global batch; the model's
dense pair is split over 'model' (`parallel.tensor_parallel`), BatchNorm
and dropout take the global batch's statistics and mask; the loss is the
rank's sum(mask * loss) over the global mask count (summed over the batch
group first), and the gradients are summed over the batch group with one
flat all-reduce, which also carries the step's loss and accuracy.
Validation sums are summed the same way, so every rank takes the same
callback branches; rank 0 alone writes checkpoints (from gathered full
tensors, the JAX key layout) and `metrics.csv`.
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
from ..parallel import all_reduce_
from ..parallel.tensor_parallel import gather_model, shard_model
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


def sum_over_batch_flat(tensors, mesh) -> list[torch.Tensor]:
    """`tensors` summed over the mesh's batch group by one all-reduce of
    their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, mesh.batch_group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(model, loss_fn: Callable, optimizer,
                    device_pipeline: Callable | None = None,
                    compute_dtype=torch.float32, seed: int = 0, mesh=None):
    """(x, y, mask, step) -> (loss, accuracy) device scalars, after one
    update of `optimizer`'s parameters (the model's).

    device_pipeline (optional): (generator, x, train) -> model input, run
    first, e.g. augmentation + the frontend kernel on raw audio.  Under a
    process `mesh`, x, y and mask are this rank's rows of the global batch
    and the model is `shard_model`'s; the loss and accuracy returned are
    the global batch's."""
    params = [p for p in model.parameters()]

    def train_step(x, y, mask, step: int):
        if device_pipeline is not None:
            x = device_pipeline(step_generator(seed, step, _PIPELINE), x, True)
        model.train()
        count = mask.sum()
        if mesh is not None:
            count = all_reduce_(count, mesh.batch_group)
        denom = torch.clamp(count, min=1.0)
        with torch.enable_grad():
            logits = model(x, compute_dtype=compute_dtype,
                           generator=step_generator(seed, step, _DROPOUT,
                                                    x.device))
            losses = loss_fn(y, logits)
            loss = (losses * mask).sum() / denom
            grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        acc = ((logits.argmax(-1) == y).float() * mask).sum() / denom
        if mesh is not None:
            *grads, metrics = sum_over_batch_flat(
                [*grads, torch.stack([loss, acc])], mesh)
            loss, acc = metrics
        optimizer.step(grads)
        return loss, acc.detach()

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
    log_tensorboard: bool = True


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
    on one device (the card unless the caller passes "cpu"), or as one rank
    of a process `mesh` (`parallel.ProcessMesh`) on the mesh's device."""

    def __init__(self, model, optimizer, model_type: str, num_classes: int,
                 config: TrainerConfig, background_bias: float | None = None,
                 checkpoint_meta: dict | None = None,
                 average_type: str | None = None,
                 device_pipeline: Callable | None = None,
                 device=DEFAULT_DEVICE, compute_dtype=torch.float32,
                 mesh=None):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.model = model.to(self.device)
        self.model_type = model_type
        self.config = config
        self.device_pipeline = device_pipeline
        self.compute_dtype = compute_dtype
        self.checkpoint_meta = checkpoint_meta or {
            "model_type": model_type, "num_classes": num_classes}
        self.loss_fn = make_loss_fn(num_classes, background_bias)
        self.optimizer = optimizer
        if mesh is not None:  # the optimizer steps this rank's shards
            shard_model(self.model, mesh)
            optimizer.bind(self.model.parameters())
        elif not optimizer.params:
            optimizer.bind(self.model.parameters())
        self.averager = None
        if average_type:
            from .averaging import WeightAverager

            self.averager = WeightAverager(average_type,
                                           self.model.parameters())
        self._train_step = make_train_step(self.model, self.loss_fn, optimizer,
                                           device_pipeline, compute_dtype,
                                           config.seed, mesh)
        self.step = optimizer.count
        self.history: list[EpochMetrics] = []

    @property
    def writer(self) -> bool:
        """Whether this process writes files and prints: rank 0 of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def _batch(self, x, y, valid):
        """A global host batch -> this process's rows on its device."""
        if self.device_pipeline is None:  # raw audio goes to the pipeline
            x = features_to_input(x, self.model_type)
        mask = (np.arange(len(y)) < valid).astype(np.float32)
        if self.mesh is not None:
            rows = self.mesh.batch_rows(len(y))
            x, y, mask = x[rows], y[rows], mask[rows]
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
        under EMA / SWA (the live BatchNorm statistics), else the model;
        under a mesh an unsharded copy, gathered over 'model' (every rank
        calls it)."""
        model = self.model
        if self.averager is not None and \
                self.averager.average_type != "lookahead":
            model = copy.deepcopy(self.model)
            with torch.no_grad():
                for p, a in zip(model.parameters(), self.averager.avg_params):
                    p.copy_(a)
        if self.mesh is not None:
            model = gather_model(model, self.mesh)
        return model

    def evaluate(self, ds: Dataset) -> dict:
        """Mean loss and accuracy over ds through the classifier kernel
        (under a mesh, each rank on its rows, the sums summed over the batch
        group)."""
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
        if self.mesh is not None:
            all_reduce_(sums, self.mesh.batch_group)
        loss_sum, correct, count = sums.tolist()
        count = max(count, 1.0)
        return {"loss": loss_sum / count, "accuracy": correct / count}

    def _current_lr(self):
        return self.optimizer.learning_rate

    def fit(self, train_ds: Dataset, val_ds: Dataset, verbose: bool = True):
        cfg = self.config
        verbose = verbose and self.writer
        ckpt = logger = None
        if self.writer:
            os.makedirs(cfg.log_dir, exist_ok=True)
            ckpt = CheckpointManager(cfg.log_dir, max_keep=cfg.max_keep,
                                     meta=self.checkpoint_meta)
            logger = MetricsLogger(cfg.log_dir,
                                   tensorboard=cfg.log_tensorboard)
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
            if logger is not None:
                logger.log(em)
            if verbose:
                print(f"Epoch {epoch}/{cfg.epochs} - {dt:.1f}s - "
                      f"loss: {em.loss:.4f} - accuracy: {em.accuracy:.4f} - "
                      f"val_loss: {em.val_loss:.4f} - "
                      f"val_accuracy: {em.val_accuracy:.4f}")
            # TerminateOnNaN
            if not np.isfinite(em.loss):
                if self.writer:
                    print("NaN loss encountered — terminating training.")
                nan_terminated = True
                break
            # best checkpoint + keep-newest cleanup
            if em.val_accuracy > best_val_acc:
                best_val_acc = em.val_accuracy
                epochs_since_best = 0
                plateau_wait = 0
                model = self.eval_model()  # a collective under a mesh
                if ckpt is not None:
                    ckpt.save_epoch(model, em)
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
            if self.writer:
                print("Not writing trained_final.npz (NaN weights); use the "
                      "last best checkpoint (ep*.npz) instead.")
        else:
            model = self.eval_model()  # a collective under a mesh
            if ckpt is not None:
                ckpt.save_final(model)
        if logger is not None:
            logger.close()
        return self.history


class MetricsLogger:
    """The CSV metrics log with the JAX package's columns, and the JAX
    logger's TensorBoard scalars (loss, accuracy, val_loss, val_accuracy
    and lr at step `epoch`): written with tf.summary where TensorFlow
    imports, as the JAX logger does, else with torch.utils.tensorboard
    where tensorboard imports; where neither does, one printed line says
    so and the CSV is the only log.  Where TensorFlow is installed, both
    writers import it, and with it what it loads (keras, and through keras
    jax where that is installed): a process that must load no jax passes
    tensorboard=False (TrainerConfig.log_tensorboard), as the multi-rank
    dry run does."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv = open(self.csv_path, "a")
        if os.path.getsize(self.csv_path) == 0:
            self._csv.write("epoch,loss,accuracy,val_loss,val_accuracy,seconds,lr\n")
        self._tf = self._torch_tb = None
        if not tensorboard:
            return
        try:
            import tensorflow as tf

            self._tf = tf.summary.create_file_writer(log_dir)
        except Exception:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._torch_tb = SummaryWriter(log_dir)
            except Exception:
                print("TensorBoard log off: neither tensorflow nor "
                      "tensorboard imports (metrics.csv only).")

    @staticmethod
    def scalars(em: EpochMetrics) -> dict:
        out = {"loss": em.loss, "accuracy": em.accuracy,
               "val_loss": em.val_loss, "val_accuracy": em.val_accuracy}
        if em.lr is not None:
            out["lr"] = em.lr
        return out

    def log(self, em: EpochMetrics):
        self._csv.write(
            f"{em.epoch},{em.loss:.6f},{em.accuracy:.6f},"
            f"{em.val_loss:.6f},{em.val_accuracy:.6f},{em.seconds:.3f},"
            f"{'' if em.lr is None else em.lr}\n")
        self._csv.flush()
        if self._tf is not None:
            import tensorflow as tf

            with self._tf.as_default(step=em.epoch):
                for tag, value in self.scalars(em).items():
                    tf.summary.scalar(tag, value)
        elif self._torch_tb is not None:
            for tag, value in self.scalars(em).items():
                self._torch_tb.add_scalar(tag, value, global_step=em.epoch)

    def close(self):
        self._csv.close()
        for writer in (self._tf, self._torch_tb):
            if writer is not None:
                writer.close()
