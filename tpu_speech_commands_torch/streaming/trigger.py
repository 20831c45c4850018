"""TriggerDetector — debounced activation state machine (counterpart of
`tpu_speech_commands/streaming/trigger.py`, a copy).

Re-implementation of the reference detector (`listen.py:525-559`): a chunk
is "activated" when its decoded score exceeds `sensitivity`; consecutive
activated chunks of the same non-background class increment a counter;
crossing `trigger_level` fires an activation and enters a refractory period
of -(8*2048)//chunk_size chunks; otherwise the counter decays toward zero.
"""
from __future__ import annotations


class TriggerDetector:
    def __init__(
        self,
        chunk_size: int,
        class_names: list[str],
        sensitivity: float = 0.5,
        trigger_level: int = 3,
    ):
        self.chunk_size = chunk_size
        self.class_names = class_names
        self.sensitivity = sensitivity
        self.trigger_level = trigger_level
        self.activation = 0
        self.record_index: int | None = None

    def update(self, index: int, score: float) -> bool:
        """Feed one prediction; returns whether it caused an activation."""
        chunk_activated = score > self.sensitivity

        if (
            self.class_names[index] != "background"
            and index == self.record_index
            and chunk_activated
        ):
            self.activation += 1
            if self.activation > self.trigger_level:
                # refractory period before the next possible trigger
                self.activation = -(8 * 2048) // self.chunk_size
                self.record_index = index
                return True
        elif self.activation < 0:
            self.activation += 1
        elif self.activation > 0:
            self.activation -= 1

        self.record_index = index
        return False

    def reset(self):
        self.activation = 0
        self.record_index = None


class TriggerDetectorArray:
    """Vectorized slot-pool twin of TriggerDetector.

    One numpy update advances N independent detector state machines —
    bit-exact with N scalar TriggerDetectors (tests/test_streaming.py) —
    so a multi-stream server's per-tick postprocess is O(1) numpy calls
    instead of a Python loop over slots.
    """

    def __init__(
        self,
        chunk_size: int,
        class_names: list[str],
        sensitivity: float = 0.5,
        trigger_level: int = 3,
        n_slots: int = 1,
    ):
        import numpy as np

        self.chunk_size = chunk_size
        self.sensitivity = sensitivity
        self.trigger_level = trigger_level
        self.refractory = -(8 * 2048) // chunk_size
        self._is_background = np.array(
            [name == "background" for name in class_names]
        )
        self.activation = np.zeros(n_slots, np.int64)
        # -1 encodes the scalar detector's record_index=None fresh state
        self.record_index = np.full(n_slots, -1, np.int64)

    def update(self, indices, scores, active=None):
        """Feed one prediction per slot; returns a bool[N] trigger mask.

        `active` (bool[N], optional) freezes the state of inactive slots —
        their entry is False and neither counter nor record_index moves.
        """
        import numpy as np

        indices = np.asarray(indices, np.int64)
        chunk_activated = np.asarray(scores) > self.sensitivity
        streak = (
            ~self._is_background[indices]
            & (indices == self.record_index)
            & chunk_activated
        )
        new_act = np.where(
            streak,
            self.activation + 1,
            self.activation - np.sign(self.activation),
        )
        fired = streak & (new_act > self.trigger_level)
        new_act = np.where(fired, self.refractory, new_act)
        if active is None:
            self.activation = new_act
            # copy: np.asarray is a no-copy view for int64 input, and a
            # caller reusing its indices buffer in place next tick would
            # otherwise rewrite our recorded classes before the streak
            # comparison runs
            self.record_index = indices.copy()
            return fired
        active = np.asarray(active, bool)
        self.activation = np.where(active, new_act, self.activation)
        self.record_index = np.where(active, indices, self.record_index)
        return fired & active

    def reset(self, slots=None):
        """Reset all slots, or only the given indices/mask."""
        if slots is None:
            self.activation[:] = 0
            self.record_index[:] = -1
        else:
            self.activation[slots] = 0
            self.record_index[slots] = -1
