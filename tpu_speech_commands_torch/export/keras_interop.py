"""Keras H5 weight interop (counterpart of
`tpu_speech_commands/export/keras_interop.py`).

The reference trains tf.keras models and ships H5 files.  This module maps
those H5 weight layouts onto the checkpoint's parameter tree (the JAX
package's names, which the port's models share), so a reference-trained
model reaches the port's kernels without retraining:

    import_h5_checkpoint("model.h5", "simple_gru", 5, "model.npz")

and builds the reference-architecture tf.keras model that `export_keras_h5`
fills from a checkpoint.  h5py and TensorFlow are imported only by the
functions that need them.

Layer-name mapping (Keras default names -> checkpoint modules):
  conv2d[_k]             -> block{k+1}/conv/kernel
  separable_conv2d[_k]   -> block{k+1}/depthwise|pointwise
  batch_normalization[_k]-> block{k+1}/bn (+ batch_stats mean/var)
  dense[_k] (backbone)   -> feature_dense
  score_predict          -> score_predict
  gru_unit_<i> / lstm_unit_<i> -> backbone/gru_unit_<i> | lstm_unit_<i>
    (the whole stack for num_layers > 1; Keras gate orders [z,r,h] /
     [i,f,c,o] match the cells in models/rnn.py; the reset_after GRU bias
     (2, 3U) splits into bias_input/bias_recurrent)
"""
from __future__ import annotations

import re

import numpy as np

from ..checkpoints import load_checkpoint
from ..params import pr
from ..training.checkpoints import save_checkpoint


def _collect_h5_weights(path: str) -> dict[str, np.ndarray]:
    """Flatten an H5 (Keras save_model or save_weights layout) to
    {path: array} with ':0' suffixes stripped."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name.split(":")[0]] = np.array(obj)

        root.visititems(visit)
    return out


def _indexed(weights: dict[str, np.ndarray], base: str) -> list[str]:
    """Top-level layer groups named base, base_1, base_2... in order."""
    names = set()
    pattern = re.compile(rf"(^|/)({re.escape(base)}(_\d+)?)/")
    for key in weights:
        m = pattern.search(key)
        if m:
            names.add(m.group(2))
    def order(n):
        m = re.search(r"_(\d+)$", n)
        return int(m.group(1)) if m else 0
    return sorted(names, key=order)


def _layer_tensor(weights, layer, suffix):
    # Exact final-segment match: suffix "kernel" must not also match
    # "recurrent_kernel"/"depthwise_kernel" (h5 keys end in "...:0").
    for key, arr in weights.items():
        last = key.split("/")[-1].split(":")[0]
        if f"{layer}/" in key and last == suffix:
            return arr
    raise KeyError(f"{layer}/{suffix} not found in H5 weights")


def load_keras_h5_weights(path: str, model_type: str, num_classes: int):
    """Returns the checkpoint's `variables` tree ({'params'[,
    'batch_stats']}) of numpy arrays for models/factory.get_model(
    model_type, num_classes)."""
    w = _collect_h5_weights(path)
    if model_type in ("simple_cnn", "simple_cnn_lite"):
        return _load_cnn(w, model_type)
    elif model_type in ("simple_gru", "simple_lstm"):
        return _load_rnn(w, model_type)
    raise ValueError(f"unsupported model type: {model_type}")


def _load_cnn(w, model_type):
    separable = model_type == "simple_cnn_lite"
    params: dict = {}
    batch_stats: dict = {}

    conv_layers = _indexed(w, "separable_conv2d" if separable else "conv2d")
    bn_layers = _indexed(w, "batch_normalization")
    assert len(conv_layers) == 4, conv_layers
    assert len(bn_layers) == 4, bn_layers
    for i, (conv, bn) in enumerate(zip(conv_layers, bn_layers)):
        block = f"block{i + 1}"
        if separable:
            depthwise = _layer_tensor(w, conv, "depthwise_kernel")
            pointwise = _layer_tensor(w, conv, "pointwise_kernel")
            bias = _layer_tensor(w, conv, "bias")
            params[block] = {
                # Keras depthwise (kh, kw, in, 1) -> the checkpoint's (kh, kw, 1, in)
                "depthwise": {"kernel": np.transpose(depthwise, (0, 1, 3, 2))},
                "pointwise": {"kernel": pointwise, "bias": bias},
            }
        else:
            params[block] = {"conv": {"kernel": _layer_tensor(w, conv, "kernel")}}
        params[block]["bn"] = {
            "scale": _layer_tensor(w, bn, "gamma"),
            "bias": _layer_tensor(w, bn, "beta"),
        }
        batch_stats[block] = {
            "bn": {
                "mean": _layer_tensor(w, bn, "moving_mean"),
                "var": _layer_tensor(w, bn, "moving_variance"),
            }
        }

    dense_layers = [d for d in _indexed(w, "dense")]
    assert dense_layers, "backbone dense layer not found"
    params["feature_dense"] = {
        "kernel": _layer_tensor(w, dense_layers[0], "kernel"),
        "bias": _layer_tensor(w, dense_layers[0], "bias"),
    }
    params["score_predict"] = {
        "kernel": _layer_tensor(w, "score_predict", "kernel"),
        "bias": _layer_tensor(w, "score_predict", "bias"),
    }
    return {"params": params, "batch_stats": batch_stats}


def _load_rnn(w, model_type):
    cell = "gru" if model_type == "simple_gru" else "lstm"
    # reference names layers {cell}_unit_0 .. {cell}_unit_{num_layers-1}
    # (classifier/models/rnn.py:28-35) — enumerate the whole stack
    units = _indexed(w, f"{cell}_unit")
    assert units, f"{cell}_unit_0 not found"

    backbone: dict = {}
    for i, layer in enumerate(units):
        assert layer == f"{cell}_unit_{i}", (
            f"non-contiguous RNN stack naming: expected {cell}_unit_{i}, "
            f"found {layer}"
        )
        kernel = _layer_tensor(w, layer, "kernel")
        recurrent = _layer_tensor(w, layer, "recurrent_kernel")
        bias = _layer_tensor(w, layer, "bias")
        if cell == "gru":
            # Keras reset_after GRU bias has shape (2, 3U): [input, recurrent]
            assert bias.ndim == 2 and bias.shape[0] == 2, bias.shape
            backbone[layer] = {
                "kernel": kernel,
                "recurrent_kernel": recurrent,
                "bias_input": bias[0],
                "bias_recurrent": bias[1],
            }
        else:
            backbone[layer] = {
                "kernel": kernel,
                "recurrent_kernel": recurrent,
                "bias": bias,
            }

    params = {
        "backbone": backbone,
        "score_predict": {
            "kernel": _layer_tensor(w, "score_predict", "kernel"),
            "bias": _layer_tensor(w, "score_predict", "bias"),
        },
    }
    return {"params": params}


def build_keras_model(model_type: str, num_classes: int, n_features: int = 30,
                      feature_size: int = 20, num_layers: int = 1,
                      dropout: bool = True):
    """Construct the reference-architecture tf.keras model for a model type
    (via the public Keras API; num_layers stacks RNN layers, the middle ones
    returning sequences).  Used for the H5, SavedModel, TFLite and pb
    exports and as the parity fixture in tests.  dropout=False leaves the
    training-only dropout out (the same function at inference): a frozen
    graph cannot fold the state of a Keras 3 dropout's seed generator."""
    import tensorflow as tf
    from tensorflow.keras import layers

    if model_type in ("simple_cnn", "simple_cnn_lite"):
        lite = model_type == "simple_cnn_lite"
        Conv = layers.SeparableConv2D if lite else layers.Conv2D
        inp = layers.Input(shape=(n_features, feature_size, 1),
                           name="feature_input")
        x = inp
        specs = [
            (16, 1, None, True),
            (32, 1, None, True),
            (64, 2, "relu" if lite else None, False),
            (128, 1, "relu", True),
        ]
        for filters, strides, act, pool in specs:
            x = Conv(filters, 3, strides=strides, padding="same",
                     use_bias=lite, activation=act)(x)
            x = layers.BatchNormalization()(x)
            x = layers.ReLU(6.0)(x)
            if pool:
                x = layers.MaxPooling2D()(x)
        x = layers.Flatten()(x)
        if dropout:
            x = layers.Dropout(0.5)(x)
        x = layers.Dense(128)(x)
        x = layers.ReLU(6.0)(x)
    elif model_type in ("simple_gru", "simple_lstm"):
        inp = layers.Input(shape=(n_features, feature_size),
                           name="feature_input")
        lstm = model_type == "simple_lstm"
        Cell = layers.LSTM if lstm else layers.GRU
        kw = dict(activation="tanh" if lstm else "linear",
                  dropout=0.2 if dropout else 0.0)
        prefix = "lstm_unit_" if lstm else "gru_unit_"
        x = inp
        for i in range(num_layers - 1):  # mid layers return sequences
            x = Cell(48, return_sequences=True, name=f"{prefix}{i}", **kw)(x)
        x = Cell(48, name=f"{prefix}{num_layers - 1}", **kw)(x)
    else:
        raise ValueError(f"unsupported model type: {model_type}")
    out = layers.Dense(num_classes, activation="softmax",
                       name="score_predict")(x)
    return tf.keras.Model(inp, out)


def keras_model_from_checkpoint(checkpoint_path: str, dropout: bool = True):
    """Native .npz checkpoint -> (tf.keras model holding its weights,
    meta), built by `build_keras_model(..., dropout=dropout)`.  The
    checkpoint's stored audio params are applied to `pr` first, as
    `load_native` does."""
    variables, meta = load_checkpoint(checkpoint_path)
    model_type = meta["model_type"]
    num_classes = meta["num_classes"]
    # adopt the checkpoint's audio params (as load_native does) so the
    # model's input shape reflects the trained n_features/feature_size, not this
    # process's defaults
    if meta.get("params"):
        pr.override(meta["params"])
    params = variables["params"]
    batch_stats = variables.get("batch_stats") or {}
    num_layers = max(
        (int(k.rsplit("_", 1)[1]) + 1
         for k in (params.get("backbone") or {}) if "_unit_" in k),
        default=1,
    )

    keras_model = build_keras_model(
        model_type, num_classes, pr.n_features, pr.feature_size,
        num_layers=num_layers, dropout=dropout,
    )

    # map by layer order (Keras auto-name counters are process-global, so
    # name-index parsing is unreliable)
    conv_i = 0
    bn_i = 0
    for layer in keras_model.layers:
        name = layer.name
        if not layer.weights:
            continue
        if name.startswith(("conv2d", "separable_conv2d")):
            conv_i += 1
            block = params[f"block{conv_i}"]
            if name.startswith("separable"):
                layer.set_weights([
                    np.transpose(block["depthwise"]["kernel"], (0, 1, 3, 2)),
                    block["pointwise"]["kernel"],
                    block["pointwise"]["bias"],
                ])
            else:
                layer.set_weights([block["conv"]["kernel"]])
        elif name.startswith("batch_normalization"):
            bn_i += 1
            block = params[f"block{bn_i}"]["bn"]
            stats = batch_stats[f"block{bn_i}"]["bn"]
            layer.set_weights([block["scale"], block["bias"],
                               stats["mean"], stats["var"]])
        elif name == "score_predict":
            layer.set_weights([params["score_predict"]["kernel"],
                               params["score_predict"]["bias"]])
        elif name.startswith("dense"):
            layer.set_weights([params["feature_dense"]["kernel"],
                               params["feature_dense"]["bias"]])
        elif name.startswith("gru_unit"):
            cell = params["backbone"][name]  # gru_unit_<i> names match
            bias = np.stack([cell["bias_input"], cell["bias_recurrent"]])
            layer.set_weights([cell["kernel"], cell["recurrent_kernel"], bias])
        elif name.startswith("lstm_unit"):
            cell = params["backbone"][name]
            layer.set_weights([cell["kernel"], cell["recurrent_kernel"],
                               cell["bias"]])
    return keras_model, meta


def export_keras_h5(checkpoint_path: str, output_file: str) -> str:
    """Native .npz checkpoint -> reference-compatible Keras H5 model.

    Inverse of `import_h5_checkpoint`: lets models trained here be used by
    the reference's eval / listen / converter tooling unchanged.
    """
    keras_model, _ = keras_model_from_checkpoint(checkpoint_path)
    # Keras 3 deprecates save_format= (warns for .h5, RAISES for other
    # paths); the extension alone selects HDF5, so default extensionless
    # paths to .h5 instead of letting Keras silently pick .keras.  The
    # RETURNED path is authoritative — it may differ from the argument.
    if not output_file.endswith((".h5", ".hdf5", ".keras")):
        output_file += ".h5"
    keras_model.save(output_file)
    return output_file


def import_h5_checkpoint(h5_path: str, model_type: str, num_classes: int,
                         output_path: str, classes: list[str] | None = None):
    """Reference H5 -> native .npz checkpoint, written by the port's
    `save_checkpoint`: the port's eval, listen, serving and export read
    it."""
    variables = load_keras_h5_weights(h5_path, model_type, num_classes)
    num_layers = max(
        (int(k.rsplit("_", 1)[1]) + 1
         for k in (variables["params"].get("backbone") or {})
         if "_unit_" in k),
        default=1,
    )
    meta = {
        "model_type": model_type,
        "num_classes": num_classes,
        "params": pr.to_dict(),
        "imported_from": h5_path,
    }
    if num_layers != 1:
        meta["num_layers"] = num_layers
    if classes:
        meta["classes"] = classes
    save_checkpoint(output_path, variables, meta)
    return output_path
