"""Multi-device dry run of the port's parallelism (counterpart of
`__graft_entry__.py::dryrun_multichip`): every sharded path once, at tiny
shapes, on a given device list and backend.

    python -m tpu_speech_commands_torch.dev.dryrun_multichip \\
        --devices cuda:0,cuda:1,cuda:2,cuda:3          # NCCL, one card a rank
    python -m tpu_speech_commands_torch.dev.dryrun_multichip \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0          # gloo, one shared card
    python -m tpu_speech_commands_torch.dev.dryrun_multichip \\
        --devices cpu,cpu,cpu,cpu                      # gloo on the CPU

One rank a device (`parallel.launch`), N ranks:
- the simple_cnn train step (sgd, dropout 0, a padded last batch: the mask
  hides two repeated rows) on the data x model mesh (model 2 where N is even
  and at least 4, as the JAX dry run), and on the hybrid replica x data x
  model mesh of the same model axis, whose loss and parameters must be
  bit-equal to it; the same pair at model 1 (flat data N against replica 2);
- the same step on raw audio with the augmentation and the frontend kernel
  in every rank (`--augment`) and dropout 0.5, held by rank 0 to the
  one-device step on the whole batch;
- a train epoch on features, an `--augment` epoch with validation (the CNN
  classifier kernel in every rank) and a GRU epoch with validation (the GRU
  kernel in every rank), through `Trainer.fit` on the data x model mesh;
then, in this process over a `Mesh` of the same devices: `evaluate_accuracy`
of the trained GRU (equal to the one-device result) and the sharded
scorer of the trained CNN.

Each rank writes `rank<r>.json` under --out (its device, its launch counts
of the frontend, GRU and CNN classifier kernels, its dense-pair shard
shapes, and any JAX module it loaded, which must be none); rank 0 writes
each step's loss and gathered variables (`step_<layout>.npz`) and the
checkpoints.  The last line is the JAX dry run's summary line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

C = 5  # classes
STEP_LR = 0.05  # sgd: a parameter's error is its gradient's times this
STEP_ATOL = 1e-5  # the sharded steps against the one-device step
FOREIGN = ("jax", "jaxlib", "flax", "optax", "tpu_speech_commands")


def feature_batch(batch: int, seed: int = 0):
    """(x (B, 30, 20, 1), y, mask): features from a numpy seed, the last two
    rows repeats of the first two and masked, as `batch_iterator` pads."""
    rng = np.random.default_rng(seed)
    valid = batch - 2
    x = (2 * rng.standard_normal((valid, 30, 20, 1))).astype(np.float32)
    y = rng.integers(0, C, valid).astype(np.int64)
    x, y = np.concatenate([x, x[:2]]), np.concatenate([y, y[:2]])
    return x, y, (np.arange(batch) < valid).astype(np.float32)


def audio_batch(batch: int, seed: int = 1):
    """(audio (B, 16000), y, mask, noise bank (2, 16000)) from a numpy seed,
    the last two rows masked."""
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((batch, 16000))).astype(np.float32)
    y = rng.integers(0, C, batch).astype(np.int64)
    noise = (0.05 * rng.standard_normal((2, 16000))).astype(np.float32)
    return audio, y, (np.arange(batch) < batch - 2).astype(np.float32), noise


def layouts(n: int) -> list[tuple[str, tuple[int, int, int]]]:
    """(name, (replica, data, model)) of the steps: the data x model mesh,
    its hybrid, and at model 1 flat data against replica x data."""
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    out = [("data_x_model", (1, n // n_model, n_model))]
    if n >= 4 and n % 2 == 0:
        out.append(("hybrid", (2, n // (2 * n_model), n_model)))
        if n_model > 1:
            out += [("data", (1, n, 1)), ("replica_x_data", (2, n // 2, 1))]
    return out


BIT_EQUAL = (("data_x_model", "hybrid"), ("data", "replica_x_data"))


def init_state(model_type: str, dropout_rate: float | None = None):
    from ..models import init_model

    model, _ = init_model(model_type, C, seed=0, dropout_rate=dropout_rate)
    return model


def one_step(model, x, y, mask, device, mesh=None, pipeline=None):
    """One sgd train step of `model` on this process's rows; returns (loss,
    the model after it, unsharded)."""
    from ..losses import make_loss_fn
    from ..optim import get_optimizer
    from ..parallel.tensor_parallel import gather_model, shard_model
    from ..training.trainer import make_train_step

    model = model.to(device)
    rows = slice(None)
    if mesh is not None:
        shard_model(model, mesh)
        rows = mesh.batch_rows(len(y))
    opt = get_optimizer("sgd", STEP_LR, decay_type=None, injectable=True,
                        params=model.parameters())
    step = make_train_step(model, make_loss_fn(C), opt, pipeline, mesh=mesh)
    loss, _ = step(*(torch.from_numpy(a[rows]).to(device) for a in (x, y, mask)),
                   0)
    return float(loss), (model if mesh is None else gather_model(model, mesh))


def flat_state(loss: float, model) -> dict[str, np.ndarray]:
    from ..training.checkpoints import flatten_variables

    return {"loss": np.float32(loss), **flatten_variables(model.variables())}


def max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k], np.float64) - b[k]).max())
               for k in a)


def write_rank_report(rank: int, device, out: str, extra: dict | None = None):
    """rank<r>.json: the device, the kernel launch counts of this process,
    and the JAX modules it loaded (none is allowed)."""
    from ..ops import cnn_kernel, frontend_kernel, rnn_kernel

    report = {
        "device": str(device),
        "launches": {
            "mfcc_frontend": frontend_kernel.mfcc_frontend_cuda.launches,
            "gru_classifier": rnn_kernel.gru_layer_cuda.launches,
            "cnn_classifier": cnn_kernel.cnn_classifier_cuda.launches},
        "foreign_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] in FOREIGN),
        **(extra or {})}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def rank_main(rank: int, device, n: int, out: str, batch: int) -> None:
    """One rank of the dry run (a spawned process), at global batch
    `batch`."""
    from ..data.augment import make_audio_pipeline
    from ..data.dataset import Dataset
    from ..ops.training_frontend import select_training_frontend
    from ..optim import get_optimizer
    from ..parallel import init_process_mesh
    from ..params import pr
    from ..training import Trainer, TrainerConfig
    from ..training.checkpoints import save_checkpoint

    # float32 convs and matmuls in float32 (cuDNN takes TF32 by default),
    # so that the sharded step and the one-device step compute alike, and
    # deterministic conv algorithms (cuDNN's default backward may sum with
    # atomics), so that two runs of one step can be bit-equal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    x, y, mask = feature_batch(batch)
    if rank == 0:
        save_checkpoint(os.path.join(out, "init_cnn.npz"),
                        init_state("simple_cnn"), {"model_type": "simple_cnn",
                                                   "num_classes": C})
    steps, shards, meshes = {}, {}, {}
    for name, shape in layouts(n):
        mesh = meshes[name] = init_process_mesh(*shape, device)
        model = init_state("simple_cnn", dropout_rate=0.0)
        loss, full = one_step(model, x, y, mask, device, mesh)
        steps[name] = flat_state(loss, full)
        shards[name] = {k: list(getattr(model, k).kernel.shape)
                        for k in ("feature_dense", "score_predict")}
        if rank == 0:
            np.savez(os.path.join(out, f"step_{name}.npz"), **steps[name])
    for a, b in BIT_EQUAL:
        if a in steps and b in steps:
            for key in steps[a]:
                if not np.array_equal(steps[a][key], steps[b][key]):
                    raise RuntimeError(f"dryrun witness failed: {b} != {a} at "
                                       f"{key} (max|d|={max_diff(steps[a], steps[b])})")
    mesh = meshes["data_x_model"]
    # no TensorBoard log: TensorFlow, where it is installed, loads jax
    # (through keras), and a rank must load none
    cfg = TrainerConfig(batch_size=batch, epochs=1, seed=0,
                        log_dir=os.path.join(out, "cnn"),
                        log_tensorboard=False)

    # the --augment step, dropout on, against the one-device step
    audio, ya, ma, noise = audio_batch(batch)
    frontend, kind = select_training_frontend(pr, "mfcc", batch, device,
                                              verbose=rank == 0, mesh=mesh)
    pipe = make_audio_pipeline(frontend, "simple_cnn", noise, device=device,
                               mesh=mesh)
    loss, full = one_step(init_state("simple_cnn"), audio, ya, ma, device,
                          mesh, pipe)
    augment_step = flat_state(loss, full)
    summary = {"frontend": kind}
    if rank == 0:
        np.savez(os.path.join(out, "step_augment.npz"), **augment_step)
        fe1, _ = select_training_frontend(pr, "mfcc", batch, device, False)
        pipe1 = make_audio_pipeline(fe1, "simple_cnn", noise, device=device)
        loss1, model1 = one_step(init_state("simple_cnn"), audio, ya, ma,
                                 device, pipeline=pipe1)
        summary["augment_vs_one_device"] = max_diff(augment_step,
                                                    flat_state(loss1, model1))
        if not summary["augment_vs_one_device"] <= STEP_ATOL:
            raise RuntimeError("dryrun witness failed: the --augment step on "
                               f"{n} ranks is {summary['augment_vs_one_device']} "
                               "from the one-device step")

    def trainer(model_type, **kw):
        return Trainer(init_state(model_type), get_optimizer(
            "adam", 1e-3, decay_type="cosine", decay_steps=100), model_type,
            C, cfg, device=device, mesh=mesh, **kw)

    rng = np.random.default_rng(2)
    feats = Dataset((2 * rng.standard_normal((4 * batch, 30, 20))).astype(
        np.float32), rng.integers(0, C, 4 * batch).astype(np.int32))
    summary["epoch_loss"] = trainer("simple_cnn").run_epoch(feats, 1)["loss"]
    audio_ds = Dataset(np.concatenate([audio, audio[::-1]]),
                       np.concatenate([ya, ya[::-1]]).astype(np.int32))
    history = trainer("simple_cnn", device_pipeline=pipe).fit(
        audio_ds, Dataset(audio, ya.astype(np.int32)), verbose=False)
    summary["audio_pipeline_loss"] = history[-1].loss
    cfg.log_dir = os.path.join(out, "gru")
    gru_ds = Dataset(feats.x[:2 * batch], feats.y[:2 * batch])
    history = trainer("simple_gru").fit(gru_ds, gru_ds, verbose=False)
    summary["gru_loss"] = history[-1].loss
    for key in ("epoch_loss", "audio_pipeline_loss", "gru_loss"):
        if not np.isfinite(summary[key]):
            raise RuntimeError(f"dryrun witness failed: {key} {summary[key]}")
    if rank == 0:
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump(summary, f)
    write_rank_report(rank, device, out, {"shards": shards})


def main(argv=None) -> dict:
    """Run the dry run; returns its summary (also under --out)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", default="cuda:0,cuda:0,cuda:0,cuda:0",
                        help="comma-separated, one rank each")
    parser.add_argument("--backend", default=None,
                        help="nccl or gloo (default: nccl for distinct "
                             "cards, else gloo)")
    parser.add_argument("--batch", type=int, default=None,
                        help="global batch (default: 2 a rank, as the JAX "
                             "dry run)")
    parser.add_argument("--out", default=None,
                        help="directory for the ranks' reports (default: a "
                             "temporary one)")
    args = parser.parse_args(argv)
    devices = args.devices.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        return run(devices, args.backend, args.out or tmp, args.batch)


def run(devices: list[str], backend: str | None, out: str,
        batch: int | None = None) -> dict:
    """The dry run on `devices` (one rank each) at global batch `batch`
    (default 2 a rank), reports under `out`; returns the summary."""
    from ..data.dataset import Dataset
    from ..evaluation import evaluate_accuracy
    from ..export.inference_loader import load_native
    from ..parallel import launch, make_mesh
    from ..serving import make_batch_scorer, make_classifier

    n = len(devices)
    batch = batch or 2 * n
    backend = backend or launch.default_backend(devices)
    os.makedirs(out, exist_ok=True)
    if torch.device(devices[0]).type == "cuda":
        from ..ops import _build

        _build.load_library()  # one build, before the ranks start
    launch.launch(rank_main, devices, backend, args=(n, out, batch))
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    summary["ranks"] = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            summary["ranks"].append(json.load(f))
    summary["backend"] = backend
    summary["batch"] = batch
    summary["layouts"] = dict(layouts(n))
    summary["loss"] = float(np.load(os.path.join(out,
                                                 "step_data_x_model.npz"))["loss"])

    # one process over the same devices: evaluation and serving
    mesh = make_mesh(n_data=n, devices=devices)
    gru = load_native(os.path.join(out, "gru", "trained_final.npz"),
                      devices[0])
    x, y, _ = feature_batch(batch, seed=3)
    ds = Dataset(x[..., 0], y.astype(np.int32))
    classifier, _ = make_classifier(gru.model, "simple_gru")
    # a batch that the mesh rounds up: its padding differs from one device's
    kw = dict(batch_size=batch // 2 + 1, save_plot=False, verbose=False)
    names = [f"c{i}" for i in range(C)]
    accuracy, conf = evaluate_accuracy(classifier, ds, "simple_gru", names,
                                       mesh=mesh, **kw)
    one = evaluate_accuracy(classifier, ds, "simple_gru", names, **kw)
    if accuracy != one[0] or not np.array_equal(conf, one[1]):
        raise RuntimeError("dryrun witness failed: evaluation on the mesh "
                           f"{accuracy} != one device {one[0]}")
    summary["gru_eval_accuracy"] = accuracy
    scorer = make_batch_scorer(os.path.join(out, "cnn", "trained_final.npz"),
                               mesh=mesh)
    audio, *_ = audio_batch(batch, seed=4)
    scores = scorer(torch.from_numpy(audio).to(devices[0])).cpu().numpy()
    if scores.shape != (batch, C) or not np.isfinite(scores).all() or \
            not np.allclose(scores.sum(-1), 1.0, atol=1e-3):
        raise RuntimeError(f"dryrun witness failed: serving scores {scores}")
    summary["serving"] = scorer.paths
    _, n_data, n_model = summary["layouts"]["data_x_model"]
    hybrid = summary["layouts"].get("hybrid")
    print(f"dryrun_multichip({n}): mesh={{'data': {n_data}, 'model': "
          f"{n_model}}} hybrid_mesh="
          f"{dict(zip(('replica', 'data', 'model'), hybrid)) if hybrid else None} "
          f"frontend={summary['frontend']} loss={summary['loss']:.4f} "
          f"epoch_loss={summary['epoch_loss']:.4f} "
          f"audio_pipeline_loss={summary['audio_pipeline_loss']:.4f} "
          f"gru_loss={summary['gru_loss']:.4f} "
          f"gru_eval_accuracy={accuracy:.4f} serving={scorer.paths}")
    return summary


if __name__ == "__main__":
    main()
