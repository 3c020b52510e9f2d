"""Faults that the CPU tests plant in the port, where an answer or a state
is produced, to see a run's ``correct`` come out false. A configuration's
entry class lists the faults its runs can have: ``faults()`` → {name:
(module, function, wrapper)}, the wrapper taking the port's function and
returning the faulty one. The benchmark's own runs plant none."""
from __future__ import annotations

import numpy as np
import torch


def altered_frames(fn, corner: bool = False, item=None):
    """``fn`` with the first frame of its uint8 answer (``item`` of its
    result, where that is a tuple) altered: inverted, or (``corner``) in
    its top-left pixel alone."""
    def altered(*args, **kwargs):
        result = fn(*args, **kwargs)
        out = result if item is None else result[item]
        out = out.clone() if isinstance(out, torch.Tensor) else np.array(out)
        if corner:
            out[0, 0, 0] = 255 - out[0, 0, 0]
        else:
            out[0] = 255 - out[0]
        if item is None:
            return out
        return tuple(out if i == item else r for i, r in enumerate(result))
    return altered


def state_unchanged(apply_update):
    """An optimizer step that counts the step and leaves the state as it was."""
    def no_update(state, loss):
        state.step += 1
    return no_update


def half_batch(loss_fn):
    """A loss over the first half of the batch alone, the mean over it."""
    return lambda pred, target: loss_fn(pred[:len(pred) // 2], target[:len(target) // 2])
