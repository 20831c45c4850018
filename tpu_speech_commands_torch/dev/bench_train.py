"""Training-step throughput: samples/s of the train step (forward,
backward, adam) a model family, and of the whole `Trainer.fit` loop
(counterpart of `tools/evaluation/bench_train.py`).

    python -m tpu_speech_commands_torch.dev.bench_train \\
        --models simple_gru,simple_cnn --batch_size 512 [--augment] \\
        [--fit] [--device cpu]

`bench_model` runs `iters` chained steps after a warm-up: 36 classes,
adam on a cosine decay, random features of the model's input shape (the
JAX tool's inputs), or with `augment=True` random audio through the
`train.py --augment` pipeline (augmentation and the frontend kernel inside
the step).  On the card the steps sit between two CUDA events; the last
loss is read and must be finite.  `bench_fit` is the wall-clock samples/s
of `Trainer.fit` (train epochs, validation through the classifier kernels,
callbacks, checkpoints), the first epoch dropped.

Not carried over: the JAX tool's `bench_fit_decompose`, which takes apart
the JAX trainer's multi-epoch device scan (epochs a dispatch, the epoch's
shuffle gather as scan inputs).  The port trains one step a batch and has
no such scan (ROADMAP.md §1 item 3), so there is nothing of it to take
apart.

The last line printed is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from ..data.augment import make_audio_pipeline
from ..data.dataset import Dataset
from ..device import DEFAULT_DEVICE, resolve_device
from ..losses import make_loss_fn
from ..models import init_model, input_shape
from ..ops.training_frontend import select_training_frontend
from ..optim import get_optimizer
from ..params import pr
from ..training import Trainer, TrainerConfig
from ..training.trainer import make_train_step

NUM_CLASSES = 36


class _Clock:
    """Elapsed ms between start() and stop(): CUDA events on the card, the
    host's clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            return self._start.elapsed_time(self._end)
        return (time.perf_counter() - self._t0) * 1e3


def make_step(model_type: str, batch_size: int, device=DEFAULT_DEVICE,
              augment: bool = False, num_classes: int = NUM_CLASSES,
              decay_type: str | None = "cosine", noise_bank=None,
              dropout_rate: float | None = None):
    """(step, model, frontend, kind): init_model's seed-0 weights on
    `device`, adam 1e-3 (on a cosine decay over 1000 steps, or with
    decay_type=None train.py's constant, injectable rate), the loss over
    num_classes, and the train step over them.  With augment=True the step
    starts with `train.py --augment`'s pipeline over noise_bank (default:
    64 clips of seeded noise): the augmentation, then the frontend chosen
    for batch_size (the frontend kernel on the card, the plain chain on
    the CPU), named by `kind`; without it frontend and kind are None."""
    device = resolve_device(device)
    model, _ = init_model(model_type, num_classes, seed=0,
                          dropout_rate=dropout_rate)
    model.to(device)
    optimizer = get_optimizer("adam", 1e-3, decay_type=decay_type,
                              decay_steps=1000,
                              injectable=decay_type is None,
                              params=model.parameters())
    pipeline = frontend = kind = None
    if augment:
        frontend, kind = select_training_frontend(pr, "mfcc", batch_size,
                                                  device, verbose=False)
        if noise_bank is None:
            noise_bank = 0.1 * np.random.default_rng(0).standard_normal(
                (64, pr.max_samples))
        pipeline = make_audio_pipeline(frontend, model_type, noise_bank,
                                       device=device)
    step = make_train_step(model, make_loss_fn(num_classes), optimizer,
                           pipeline)
    return step, model, frontend, kind


def bench_model(model_type: str, batch_size: int, iters: int = 50,
                device=DEFAULT_DEVICE, augment: bool = False,
                warmup: int = 3) -> dict:
    """ms a step and samples/s of `iters` chained train steps of
    `make_step` (36 classes, adam on a cosine decay) at batch_size, after
    `warmup` steps.  With augment=True the input is raw audio through the
    augmentation and the frontend (kernel on the card), timed alone too
    ("frontend_ms")."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    step, _, frontend, kind = make_step(model_type, batch_size, device,
                                        augment)
    if augment:
        x = rng.uniform(-0.5, 0.5, (batch_size, pr.max_samples))
    else:
        x = rng.standard_normal((batch_size,) + input_shape(model_type))
    x = torch.tensor(x.astype(np.float32), device=device)
    y = torch.tensor(rng.integers(0, NUM_CLASSES, batch_size), device=device)
    mask = torch.ones(batch_size, device=device)

    for i in range(warmup):
        loss, _ = step(x, y, mask, i)
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"{model_type}: warm-up loss {float(loss)}")
    clock = _Clock(device)
    clock.start()
    for i in range(iters):
        loss, _ = step(x, y, mask, warmup + i)
    ms = clock.stop()
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"{model_type}: loss {loss} after {iters} steps")
    step_ms = ms / iters
    out = {"model_type": model_type, "batch_size": batch_size,
           "iters": iters, "device": str(device),
           "input": "audio (--augment)" if augment else "features",
           "step_ms": step_ms, "samples_per_s": batch_size / step_ms * 1e3,
           "loss": loss}
    if augment:
        clock.start()
        for _ in range(20):
            frontend(x)
        fe_ms = clock.stop() / 20
        out.update(frontend=kind, frontend_ms=fe_ms,
                   frontend_share=fe_ms / step_ms)
    return out


def bench_fit(model_type: str, batch_size: int, n_samples: int, epochs: int,
              device=DEFAULT_DEVICE) -> float:
    """Wall-clock samples/s of `Trainer.fit` over random features, the
    first epoch dropped (it builds the kernels' constants)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_samples, 30, 20)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, n_samples).astype(np.int32)
    xv = rng.standard_normal((max(batch_size, 512), 30, 20)).astype(np.float32)
    yv = rng.integers(0, NUM_CLASSES, len(xv)).astype(np.int32)
    model, _ = init_model(model_type, NUM_CLASSES, seed=0)
    optimizer = get_optimizer("adam", 1e-3, decay_type="cosine",
                              decay_steps=10 ** 6)
    with tempfile.TemporaryDirectory() as log_dir:
        cfg = TrainerConfig(batch_size=batch_size, epochs=epochs,
                            log_dir=log_dir, log_tensorboard=False)
        trainer = Trainer(model, optimizer, model_type, NUM_CLASSES, cfg,
                          device=device)
        history = trainer.fit(Dataset(x, y), Dataset(xv, yv), verbose=False)
    steady = history[1:]
    secs = sum(m.seconds for m in steady)
    return len(steady) * (n_samples // batch_size) * batch_size / secs


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--models", default="simple_cnn,simple_cnn_lite,"
                                            "simple_gru,simple_lstm")
    parser.add_argument("--augment", action="store_true",
                        help="raw audio through train.py --augment's "
                             "pipeline instead of random features")
    parser.add_argument("--fit", action="store_true",
                        help="also measure the full fit-loop wall clock")
    parser.add_argument("--fit_samples", type=int, default=13312)
    parser.add_argument("--fit_epochs", type=int, default=30)
    parser.add_argument("--fit_batch", type=int, default=512)
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rows = []
    for model_type in args.models.split(","):
        row = bench_model(model_type, args.batch_size, args.iters,
                          args.device, args.augment)
        print(f"{model_type}: {row['samples_per_s']:,.0f} samples/s, "
              f"{row['step_ms']:.4f} ms a step (batch {args.batch_size}, "
              f"fwd+bwd+adam, {row['input']}, {row['device']})")
        if args.fit:
            step = bench_model(model_type, args.fit_batch, args.iters,
                               args.device)
            fit = bench_fit(model_type, args.fit_batch, args.fit_samples,
                            args.fit_epochs, args.device)
            row.update(fit_samples_per_s=fit,
                       fit_step_samples_per_s=step["samples_per_s"])
            print(f"{model_type}: fit loop {fit:,.0f} vs pure step "
                  f"{step['samples_per_s']:,.0f} samples/s (batch "
                  f"{args.fit_batch}, ratio "
                  f"{fit / step['samples_per_s']:.2f})")
        rows.append(row)
    result = {"bench_train": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
