"""Multi-stream serving demo: N concurrent audio streams, one device tick
(counterpart of `tools/serving/stream_server.py`, with the same flags and
`--device`).

The deployable counterpart of listen's single-stream loop: a fixed pool of
serving slots, each holding an independent stream (its own pending-sample
counter, `streaming/feature_stream.py`), advanced by one fused tick per
chunk on the device:

    (states, chunks) -> ring update -> incremental MFCC
                     -> classifier (its kernel on the card) -> scores

for a native `.npz` model.  An exported model (`.tscm`, onnx, tflite, h5,
SavedModel, pb) runs on the host: the tick's update runs on the device and
the (slots, n_features, n_mfcc) features go to the model's runtime.

Streams may join and leave at any tick — a freed slot is zeroed with
reset_streams() on admission, so a new caller never sees the previous
stream's audio — and the pool runs the reference post-processing
(ThresholdDecoder + TriggerDetector) on the host at chunk cadence,
vectorised over the slots: one `decode_array` and one
`TriggerDetectorArray.update` a tick.  A tick with no active slot runs the
ring update only.

Demo mode: replays wav files into slots with staggered joins and prints
per-slot trigger events.

    python -m tpu_speech_commands_torch.stream_server --wavs a.wav b.wav \\
        --slots 8 --classes_path configs/direction_classes.txt \\
        --model_path pretrained/direction_simple_gru.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data.wav import load_wav
from .device import DEFAULT_DEVICE, resolve_device
from .export.inference_loader import (load_inference_model,
                                      resolve_checkpoint_contract)
from .frontend.dsp import Frontend
from .params import inject_params, pr
from .serving import make_classifier
from .streaming import (ThresholdDecoder, TriggerDetectorArray,
                        init_stream_state, make_stream_step,
                        make_stream_update, reset_streams)
from .utils import ensure_background_first, get_classes


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--classes_path", required=True)
    parser.add_argument("--wavs", nargs="+", required=True,
                        help="wav files; assigned to free slots in order")
    parser.add_argument("--slots", type=int, default=8,
                        help="serving capacity (streams per device tick)")
    parser.add_argument("--chunk_size", type=int, default=1024)
    parser.add_argument("--stagger", type=int, default=3,
                        help="ticks between stream admissions")
    parser.add_argument("--sensitivity", type=float, default=0.5)
    parser.add_argument("--trigger_level", type=int, default=3)
    parser.add_argument("--params_path", default=None)
    parser.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> list[dict]:
    """Serve the wavs; returns the trigger events, each {"tick", "slot",
    "wav", "chunk" (the stream's own chunk index), "command"}."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.slots < 1:
        parser.error("--slots must be >= 1 (0 slots can never admit a "
                     "stream, so the serve loop would spin forever)")
    device = resolve_device(args.device)
    classes = get_classes(args.classes_path)
    ensure_background_first(classes)

    # load FIRST (a native checkpoint restores its stored train-time
    # params), then --params_path wins on top — the same precedence as
    # listen and eval
    predictor, model_format = load_inference_model(args.model_path, device)
    if args.params_path:
        inject_params(args.params_path)
    p = pr.replace()
    feature_type = resolve_checkpoint_contract(predictor, model_format,
                                               class_names=classes)
    frontend = Frontend(p, feature_type=feature_type, device=device)
    update = make_stream_update(frontend, args.chunk_size)
    if model_format == "NATIVE":
        classifier, _ = make_classifier(predictor.model, predictor.model_type)
        step = make_stream_step(update, classifier, predictor.model_type)

        def tick_scores(states, chunks):
            states, scores = step(states, chunks)
            return states, scores.cpu().numpy()
    else:
        # the host runtime scores the features the device's update made
        def tick_scores(states, chunks):
            states, feats = update(states, chunks)
            return states, np.asarray(predictor(feats.cpu().numpy()))

    n_slots = args.slots
    states = init_stream_state(p, n_streams=n_slots, device=device)
    decoder = ThresholdDecoder(p.threshold_config, p.threshold_center)
    detector = TriggerDetectorArray(args.chunk_size, classes,
                                    args.sensitivity, args.trigger_level,
                                    n_slots=n_slots)

    # host-side slot bookkeeping
    slot_wav = [None] * n_slots    # active wav audio per slot
    slot_pos = [0] * n_slots
    slot_name = [""] * n_slots
    slot_start = [0] * n_slots     # the tick of admission
    pending = list(args.wavs)
    tick = 0
    served = 0
    events = []

    def admit():
        nonlocal states
        free = [i for i in range(n_slots) if slot_wav[i] is None]
        if not free or not pending:
            return
        slot = free[0]
        path = pending.pop(0)
        audio = load_wav(path, sample_rate=p.sample_rate)
        mask = np.zeros(n_slots, bool)
        mask[slot] = True
        states = reset_streams(states, mask)
        detector.reset(slot)
        slot_wav[slot] = audio.astype(np.float32)
        slot_pos[slot] = 0
        slot_name[slot] = os.path.basename(path)
        slot_start[slot] = tick
        print(f"[tick {tick}] slot {slot} <- {slot_name[slot]} "
              f"({len(audio)} samples)")

    while pending or any(w is not None for w in slot_wav):
        if tick % max(args.stagger, 1) == 0:
            admit()

        chunks = np.zeros((n_slots, args.chunk_size), np.float32)
        active = []
        for i in range(n_slots):
            if slot_wav[i] is None:
                continue
            lo = slot_pos[i]
            piece = slot_wav[i][lo : lo + args.chunk_size]
            chunks[i, : len(piece)] = piece
            slot_pos[i] += args.chunk_size
            active.append(i)
        chunks_dev = torch.from_numpy(chunks).to(device)

        if active:
            states, scores = tick_scores(states, chunks_dev)
            idx = scores.argmax(axis=1)
            conf = scores[np.arange(n_slots), idx].astype(np.float64)
            non_bg = idx != 0
            conf[non_bg] = decoder.decode_array(conf[non_bg])
            active_mask = np.zeros(n_slots, bool)
            active_mask[active] = True
            fired = detector.update(idx, conf, active_mask)
            for i in np.nonzero(fired)[0]:
                print(f"[tick {tick}] slot {i} ({slot_name[i]}): "
                      f"command '{classes[idx[i]]}' detected!")
                events.append({"tick": tick, "slot": int(i),
                               "wav": slot_name[i],
                               "chunk": tick - slot_start[i],
                               "command": classes[idx[i]]})
        else:
            # idle tick: the ring update only, no classifier launch for
            # scores nobody reads
            states, _ = update(states, chunks_dev)

        for i in list(active):
            if slot_pos[i] >= len(slot_wav[i]):
                print(f"[tick {tick}] slot {i} ({slot_name[i]}) finished")
                slot_wav[i] = None
                served += 1
        tick += 1

    print(f"served {served} streams over {tick} ticks "
          f"({n_slots} slots, {model_format} model)")
    return events


if __name__ == "__main__":
    main()
