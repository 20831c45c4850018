"""Accuracy parity, the torch stage: the port trained on the synthetic
corpus with the reference recipe, held against a recorded tf.keras stage
(counterpart of `tools/evaluation/accuracy_parity.py`'s training leg).

    python -m tpu_speech_commands_torch.dev.accuracy_parity \\
        --distribution easy --samples_per_class 371 --epochs 100 \\
        --seed 0 1 2 --model_type simple_cnn simple_cnn_lite simple_gru \\
        simple_lstm --keras_stage docs/parity/keras_stage_easy_371spc_100ep.json

1. The 36-class synthetic corpus of the JAX tool
   (`data/synthetic.make_synthetic_dataset(seed=7, hard=...)`), its
   features extracted once through `ops.MfccFrontend` (the frontend kernel
   on the card) and written to the per-sample cache, then read back from
   the cache: the cache's order is the one every later process sees, so
   the splits and the fingerprint are taken on it, as in the JAX tool.
   The cache names its files at random, so this corpus orders each
   class's clips otherwise than the recorded Keras run's did (its file
   names are not in the repository): a seed's split takes the same
   positions, hence the same class mix, but not the same clips.
2. The stage configuration, as the JAX tool fingerprints it.  With
   `--keras_stage` every field must equal the stage file's `__config__`,
   the corpus shape included, except the fingerprint's two sums, which
   come from the port's features and must agree within FINGERPRINT_RTOL
   (relative); the tool refuses to run otherwise and names both values.
3. A fresh shuffled split a seed (the JAX tool's code), then the port's
   `Trainer` with the JAX tool's recipe: batch 512, adam with no decay and
   an injectable rate, no plateau, no early stop, no TensorBoard; the
   validation pass of each epoch runs the classifier kernels on the card.
   The score is the last epoch's val_accuracy.
4. The JAX tool's markdown table with a "torch (port)" column beside
   "Keras" and the difference of the means, and a torch-stage JSON
   (`--out`) with every seed's accuracy, rewritten after each run.  The
   JAX tool's per-seed mean |Keras-JAX| is not printed: the two sides of
   a seed here are trained on different clips (step 1).

Not carried over: the cross-load leg (Keras-trained `.h5` files into the
model), which needs the `.h5` files the stage JSON names; they are not in
the repository.  The Keras side is not trained here either: it is read
from the stage file (the card's machine has no TensorFlow).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..data.dataset import Dataset, get_dataset
from ..data.synthetic import make_synthetic_dataset
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import init_model
from ..ops.frontend_kernel import MfccFrontend
from ..optim import get_optimizer
from ..params import pr
from ..training import Trainer, TrainerConfig
from ..utils import get_classes

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLASSES_PATH = os.path.join(REPO, "configs", "speech_commands_classes.txt")
# the fingerprint's sums over the port's features against XLA's: the f32
# frontends sum in other orders (CHANGES.md has the measured differences)
FINGERPRINT_RTOL = 1e-5


def build_corpus(work_dir: str, samples_per_class: int, distribution: str,
                 device, classes=None):
    """(x, y, classes): the synthetic corpus under work_dir, its features
    in the cache's order (extracted through MfccFrontend on `device`, then
    read back from the per-sample cache)."""
    classes = classes or get_classes(CLASSES_PATH)
    tag = "" if distribution == "easy" else f"_{distribution}"
    ds_root = os.path.join(work_dir, f"ds36_{samples_per_class}{tag}")
    frontend = MfccFrontend(pr, "mfcc", device)
    if not os.path.isdir(os.path.join(ds_root, "sounds")):
        print(f"Building {len(classes)}-class synthetic dataset "
              f"({samples_per_class}/class, {distribution}) ...")
        make_synthetic_dataset(ds_root, classes,
                               samples_per_class=samples_per_class, seed=7,
                               hard=distribution == "hard")
        # extract and write the cache, then discard this order: a first
        # extraction is in sound-file order, the cache in its file names'
        get_dataset(ds_root, classes, frontend=frontend)
    full = get_dataset(ds_root, classes, frontend=frontend)
    return (np.asarray(full.x, np.float32), np.asarray(full.y, np.int64),
            classes)


def stage_config(args, x: np.ndarray, n_classes: int) -> dict:
    """The JAX tool's stage fingerprint, on the port's features."""
    return {
        "schema": 1,
        "distribution": args.distribution,
        "samples_per_class": args.samples_per_class,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "val_split": args.val_split,
        "n_classes": n_classes,
        "n_samples": int(len(x)),
        "corpus_fingerprint": [float(x.sum()), float(abs(x).sum()),
                               list(x.shape)],
    }


def fingerprint_rel_diff(recorded: dict, current: dict) -> list[float]:
    """|current - recorded| / |recorded| of the fingerprint's two sums."""
    return [abs(c - r) / max(abs(r), 1e-30) for r, c in zip(
        recorded["corpus_fingerprint"][:2], current["corpus_fingerprint"][:2])]


def check_stage(recorded: dict | None, current: dict, rtol: float,
                stage_path: str) -> list[float]:
    """SystemExit, naming both values, unless `recorded` (a stage file's
    __config__) equals `current` field for field, the fingerprint's two sums
    within rtol; returns their relative differences."""
    def refuse(what, found, want):
        raise SystemExit(
            f"stage file {stage_path} was produced with a different "
            f"configuration: {what}\n  recorded: {found}\n  current:  {want}\n"
            "Match the flags it was recorded with, or use another stage "
            "file.")

    if not isinstance(recorded, dict):
        refuse("no __config__", recorded, current)
    for key in sorted(set(recorded) | set(current)):
        if key == "corpus_fingerprint":
            continue
        if recorded.get(key) != current.get(key):
            refuse(key, recorded.get(key), current.get(key))
    found = recorded.get("corpus_fingerprint")
    want = current["corpus_fingerprint"]
    if not isinstance(found, list) or len(found) != 3 or \
            list(found[2]) != list(want[2]):
        refuse("corpus_fingerprint shape", found, want)
    rel = fingerprint_rel_diff(recorded, current)
    if not max(rel) <= rtol:
        refuse(f"corpus_fingerprint sums (relative difference "
               f"{max(rel):.3e} > rtol {rtol:g})", found, want)
    return rel


def split(n: int, seed: int, val_split: float):
    """(val_idx, train_idx): the JAX tool's per-seed shuffled split."""
    order = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_split)
    return order[:n_val], order[n_val:]


def train_torch(args, model_type: str, seed: int, n_classes: int,
                x_train, y_train, x_val, y_val, device) -> float:
    """The JAX tool's `train_jax` recipe on the port's Trainer; returns the
    last epoch's val_accuracy."""
    optimizer = get_optimizer("adam", args.learning_rate, decay_type=None,
                              injectable=True)
    model, _ = init_model(model_type, n_classes, seed=seed)
    cfg = TrainerConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        log_dir=os.path.join(args.work_dir, "torch_logs"),
        log_tensorboard=False, seed=seed,
        # a pure fit-loop contest, as model.fit has no plateau or early stop
        use_plateau=False, early_stopping_patience=10 ** 9,
    )
    trainer = Trainer(model, optimizer, model_type, n_classes, cfg,
                      device=device)
    history = trainer.fit(Dataset(x_train, np.asarray(y_train, np.int32)),
                          Dataset(x_val, np.asarray(y_val, np.int32)),
                          verbose=False)
    acc = history[-1].val_accuracy
    print(f"  torch final val_accuracy: {acc:.4f}", flush=True)
    return acc


def fmt(vals) -> str:
    vals = np.asarray(vals, np.float64)
    if len(vals) == 0:
        return "—"
    if len(vals) == 1:
        return f"**{vals[0]:.4f}**"
    return f"**{vals.mean():.4f} ± {vals.std(ddof=1):.4f}**"


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_type", dest="model_types", nargs="+",
                        default=["simple_cnn"],
                        help="one or more families to compare")
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--samples_per_class", type=int, default=60)
    parser.add_argument("--val_split", type=float, default=0.15)
    parser.add_argument("--seed", dest="seeds", type=int, nargs="+",
                        default=[42],
                        help="one run a seed (the split, init and shuffling)")
    parser.add_argument("--work_dir", default=os.path.join(
        tempfile.gettempdir(), "accuracy_parity_torch"))
    parser.add_argument("--distribution", default="easy",
                        choices=["easy", "hard"])
    parser.add_argument("--keras_stage", default=None,
                        help="a recorded keras stage JSON (its __config__ "
                             "must match; its per-seed accuracies fill the "
                             "Keras column)")
    parser.add_argument("--out", default=None,
                        help="torch-stage JSON (default: in --work_dir)")
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)
    x, y, classes = build_corpus(args.work_dir, args.samples_per_class,
                                 args.distribution, device)
    config = stage_config(args, x, len(classes))
    keras_stage, rel = {}, None
    if args.keras_stage:
        with open(args.keras_stage) as f:
            keras_stage = json.load(f)
        rel = check_stage(keras_stage.get("__config__"), config,
                          FINGERPRINT_RTOL, args.keras_stage)
        print(f"stage {args.keras_stage}: config matches; fingerprint sums "
              f"relative differences {rel[0]:.3e}, {rel[1]:.3e} (rtol "
              f"{FINGERPRINT_RTOL:g})")

    out_path = args.out or os.path.join(
        args.work_dir, f"torch_stage_{args.distribution}_"
        f"{args.samples_per_class}spc_{args.epochs}ep.json")
    stage = {"__config__": config, "__device__": str(device),
             "__fingerprint_rel_diff__": rel}
    results = {m: {"keras": [], "torch": []} for m in args.model_types}
    for seed in args.seeds:
        val_idx, train_idx = split(len(x), seed, args.val_split)
        print(f"\n-- seed {seed}: train {len(train_idx)} / val {len(val_idx)} "
              f"samples, {len(classes)} classes --")
        for model_type in args.model_types:
            print(f"[seed {seed}] {model_type}:", flush=True)
            keras_acc = None
            if args.keras_stage:
                try:
                    keras_acc = keras_stage[model_type][str(seed)]["acc"]
                except KeyError:
                    raise SystemExit(
                        f"stage file {args.keras_stage} has no entry for "
                        f"model '{model_type}' seed {seed}") from None
                print(f"  keras final val_accuracy: {keras_acc:.4f} "
                      "(from the keras stage)")
                results[model_type]["keras"].append(keras_acc)
            t0 = time.perf_counter()
            acc = train_torch(args, model_type, seed, len(classes),
                              x[train_idx], y[train_idx], x[val_idx],
                              y[val_idx], device)
            results[model_type]["torch"].append(acc)
            stage.setdefault(model_type, {})[str(seed)] = {
                "acc": acc, "keras_acc": keras_acc,
                "seconds": time.perf_counter() - t0}
            with open(out_path, "w") as f:  # progress, a run at a time
                json.dump(stage, f, indent=1)

    n_val = int(len(x) * args.val_split)
    print(f"\n== accuracy parity (final val top-1; {len(args.seeds)} "
          f"seed(s), val n={n_val}, {device}) ==")
    summary = {}
    for model_type, r in results.items():
        line = (f"| {model_type} ({len(classes)}-class synthetic, batch "
                f"{args.batch_size}, adam {args.learning_rate}, "
                f"{args.epochs} epochs) | Keras (reference arch): "
                f"{fmt(r['keras'])} | torch (port): {fmt(r['torch'])} |")
        summary[model_type] = {"torch_mean": float(np.mean(r["torch"]))}
        if r["keras"]:
            mean_gap = float(np.mean(r["torch"]) - np.mean(r["keras"]))
            line += f" mean torch − mean Keras: {mean_gap:+.4f} |"
            summary[model_type].update(keras_mean=float(np.mean(r["keras"])),
                                       mean_gap=mean_gap)
        print(line)
    stage["__summary__"] = summary
    with open(out_path, "w") as f:
        json.dump(stage, f, indent=1)
    print(f"torch stage -> {out_path}")
    return stage


if __name__ == "__main__":
    main()
