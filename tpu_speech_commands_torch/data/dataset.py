"""Dataset pipeline (counterpart of `tpu_speech_commands/data/dataset.py`).

Layout contract, as in the JAX package and the reference:

    <dataset>/sounds/<class_name>/*.wav        raw audio
    <dataset>/features/<class_name>/*.npy      per-sample feature cache

Wavs are decoded on the host into fixed-length buffers and the features are
computed batched through `ops.MfccFrontend` on its device (the frontend
kernel on the card, the plain chain on the CPU).  The per-sample `.npy`
cache is read and written as the reference lays it out.  The packed cache
(`features_packed.npz`) carries a fingerprint of the source tree that also
names this package and the frontend params, so a pack the JAX package wrote,
or one written for other params, is never read here.
"""
from __future__ import annotations

import json
import os
import uuid
from dataclasses import dataclass
from glob import glob

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..params import pr
from .wav import load_wav


@dataclass
class Dataset:
    """In-memory dataset: x features (or raw audio), y integer labels."""

    x: np.ndarray  # (N, n_features, feature_size) float32, or (N, S) audio
    y: np.ndarray  # (N,) int32

    def __len__(self):
        return len(self.x)


def get_sample_list(dataset_path: str, class_names: list[str]) -> dict[str, list[str]]:
    """Scan <dataset>/sounds/<class>/*.wav; error on a missing class dir."""
    sound_root = os.path.join(dataset_path, "sounds")
    samples = {}
    for class_name in class_names:
        class_dir = os.path.join(sound_root, class_name)
        if not os.path.isdir(class_dir):
            raise ValueError(f"class dir {class_dir} does not exist")
        samples[class_name] = sorted(glob(os.path.join(class_dir, "*.wav")))
    return samples


def load_audio_batch(wav_paths: list[str], params=None) -> np.ndarray:
    """Decode wavs into a fixed-length float32 batch (N, max_samples),
    left-zero-padded / tail-truncated."""
    p = params or pr
    out = np.zeros((len(wav_paths), p.max_samples), dtype=np.float32)
    for i, path in enumerate(wav_paths):
        audio = load_wav(path, p.sample_rate)[: p.max_samples]
        out[i, p.max_samples - len(audio):] = audio
    return out


def extract_features_batched(
    wav_paths: list[str],
    frontend,
    batch_size: int = 512,
    params=None,
) -> np.ndarray:
    """Features for a list of wavs, `batch_size` clips a frontend call.

    `frontend` is an `ops.MfccFrontend` (or any callable with its `.device`
    and (B, max_samples) -> (B, T, F) contract); each batch of decoded audio
    goes to its device."""
    p = params or pr
    device = getattr(frontend, "device", torch.device("cpu"))
    feats = []
    for start in range(0, len(wav_paths), batch_size):
        audio = load_audio_batch(wav_paths[start:start + batch_size], p)
        with torch.no_grad():
            out = frontend(torch.from_numpy(audio).to(device))
        feats.append(out.float().cpu().numpy())
    return np.concatenate(feats) if feats else np.zeros((0, 0, 0), np.float32)


def save_features_npy(dataset_path: str, class_name: str,
                      features: np.ndarray) -> None:
    """Write the reference-compatible per-sample .npy cache."""
    feat_dir = os.path.join(dataset_path, "features", class_name)
    os.makedirs(feat_dir, exist_ok=True)
    for feat in features:
        np.save(os.path.join(feat_dir, f"{uuid.uuid4()}.npy"), feat)


def _load_cached_class(feat_dir: str):
    files = sorted(glob(os.path.join(feat_dir, "*.npy")))
    return np.stack([np.load(f) for f in files]) if files else None


def get_audio_dataset(
    dataset_path: str,
    class_names: list[str],
    val_split: float | None = None,
    seed: int = 0,
    params=None,
):
    """Raw audio (fixed-length, left-padded) instead of features, for the
    augmentation + frontend training path: x is (N, max_samples) float32.
    Returns Dataset or (train, val) like get_dataset."""
    p = params or pr
    samples = get_sample_list(dataset_path, class_names)
    xs, ys = [], []
    for idx, class_name in enumerate(class_names):
        paths = samples[class_name]
        if not paths:
            continue
        xs.append(load_audio_batch(paths, p))
        ys.append(np.full(len(paths), idx, np.int32))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    if val_split is None:
        return Dataset(x, y)
    return _shuffled_split(x, y, val_split, seed)


def _shuffled_split(x, y, val_split: float, seed: int):
    """(train, val) Datasets via a shuffled split: the JAX package's
    permutation, numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    n_val = int(round(len(x) * val_split))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    return Dataset(x[train_idx], y[train_idx]), Dataset(x[val_idx], y[val_idx])


PACKED_CACHE = "features_packed.npz"
_PACK_OWNER = "tpu_speech_commands_torch"


def _cache_fingerprint(dataset_path: str, class_names: list[str],
                       params=None) -> str:
    """Content fingerprint of the source tree a pack snapshots, led by this
    package's name and the frontend params: per class, the file count and
    the newest mtime over the wavs and the per-sample .npy cache."""
    p = params or pr
    parts = [_PACK_OWNER, json.dumps(p.to_dict(), sort_keys=True)]
    for class_name in class_names:
        for root in ("sounds", "features"):
            for cand in (class_name, class_name.lower()):
                d = os.path.join(dataset_path, root, cand)
                if not os.path.isdir(d):
                    continue
                pat = "*.wav" if root == "sounds" else "*.npy"
                files = glob(os.path.join(d, pat))
                max_t = max((os.path.getmtime(f) for f in files), default=0.0)
                parts.append(f"{root}/{cand}:{len(files)}:{max_t:.6f}")
    return ";".join(parts)


def pack_cache(dataset_path: str, class_names: list[str], params=None,
               device=DEFAULT_DEVICE) -> str:
    """Consolidate the per-sample .npy cache into one packed file, read by
    `get_dataset` in one archive read instead of a file a sample (features
    missing from the cache are extracted on `device` first)."""
    ds = get_dataset(dataset_path, class_names, use_cache=True, params=params,
                     device=device)
    out = os.path.join(dataset_path, PACKED_CACHE)
    np.savez(out, x=ds.x, y=ds.y,
             classes=np.array(class_names, dtype=np.str_),
             fingerprint=np.array(
                 _cache_fingerprint(dataset_path, class_names, params),
                 dtype=np.str_))
    return out


def _load_packed(dataset_path: str, class_names: list[str], params=None):
    """The packed cache when its fingerprint and class list match, else
    None (a pack without a fingerprint, or another package's, is stale)."""
    path = os.path.join(dataset_path, PACKED_CACHE)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        if "fingerprint" not in data.files or str(data["fingerprint"]) != \
                _cache_fingerprint(dataset_path, class_names, params):
            return None
        if [str(c) for c in data["classes"]] != list(class_names):
            return None
        return Dataset(np.asarray(data["x"]), np.asarray(data["y"]))


def get_dataset(
    dataset_path: str,
    class_names: list[str],
    val_split: float | None = None,
    frontend=None,
    batch_size: int = 512,
    use_cache: bool = True,
    seed: int = 0,
    params=None,
    device=DEFAULT_DEVICE,
):
    """Load (or build) the feature dataset.

    Returns Dataset, or (train_ds, val_ds) when val_split is given.  Labels
    are class indices in `class_names` order; the `features/` dir
    short-circuits extraction like the reference cache.  Without a
    `frontend`, features come from `MfccFrontend(params, "mfcc", device)`
    (the card unless the caller passes "cpu")."""
    p = params or pr
    feature_root = os.path.join(dataset_path, "features")
    xs, ys = [], []

    packed = _load_packed(dataset_path, class_names, p) if use_cache else None
    if packed is not None:
        xs, ys = [packed.x], [packed.y]
    elif use_cache and os.path.isdir(feature_root):
        for idx, class_name in enumerate(class_names):
            feats = _load_cached_class(os.path.join(feature_root, class_name.lower()))
            if feats is None:
                feats = _load_cached_class(os.path.join(feature_root, class_name))
            if feats is None:
                sound_dir = os.path.join(dataset_path, "sounds", class_name)
                if os.path.isdir(sound_dir) and not glob(
                        os.path.join(sound_dir, "*.wav")):
                    # a class with no wavs is skipped at build time, so a
                    # cached reload skips it too
                    continue
                raise ValueError(f"no cached features for class {class_name}")
            xs.append(np.squeeze(feats, axis=-1) if feats.ndim == 4 else feats)
            ys.append(np.full(len(feats), idx, np.int32))
    else:
        if frontend is None:
            from ..ops.frontend_kernel import MfccFrontend

            frontend = MfccFrontend(p, "mfcc", device)
        samples = get_sample_list(dataset_path, class_names)
        for idx, class_name in enumerate(class_names):
            paths = samples[class_name]
            if not paths:
                continue
            feats = extract_features_batched(paths, frontend, batch_size, p)
            xs.append(feats)
            ys.append(np.full(len(feats), idx, np.int32))
            if use_cache:
                save_features_npy(dataset_path, class_name, feats)

    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    if val_split is None:
        return Dataset(x, y)
    return _shuffled_split(x, y, val_split, seed)


def batch_iterator(
    ds: Dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
    pad_final: bool = True,
):
    """Yield (x, y, valid_count) host batches.

    The final short batch is padded to `batch_size` with REPEATED real rows
    (valid_count marks the real ones): they are masked out of the loss and
    the metrics but enter BatchNorm's batch statistics, which zero rows
    would skew."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        x, y = ds.x[idx], ds.y[idx]
        valid = len(idx)
        if valid < batch_size:
            if drop_remainder:
                return
            if pad_final:
                pad = batch_size - valid
                rep = np.arange(pad) % max(valid, 1)
                x = np.concatenate([x, x[rep]])
                y = np.concatenate([y, y[rep]])
        yield x, y, valid
