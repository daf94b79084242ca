"""Faults planted under the timed path, for the tests and the calibration
of the check's limits: each is ``fault(cell, timed)``, applied after the
cell is built and before ``Trainer.fit`` runs, and breaks the program's
step underneath the window's own call.

* ``state_unchanged``: the optimizer's update returns its state and
  touches no parameter;
* ``half_batch``: the step sees only the first half of the batch's real
  edges, the loss the mean over them.

A one-chip training cell has no exchange between chips to leave out, and
no answer to alter where it is produced other than the update itself.
"""

from __future__ import annotations

import torch


def _unchanged(grads, state, params, g_norm=None):
    return state


def state_unchanged(cell, timed):
    inner = timed.inner
    if getattr(inner, "tx", None) is not None:
        inner.tx.update = _unchanged
        return
    configure = inner.configure_optimizers

    def configure_optimizers(*args, **kwargs):
        configure(*args, **kwargs)
        inner.tx.update = _unchanged

    inner.configure_optimizers = configure_optimizers


def half_batch(cell, timed):
    inner = timed.inner
    step = inner.train_step
    if hasattr(inner, "rel"):
        # the typed step: half the train edges, and the negatives' columns
        e = inner.rel.shape[0] // 2
        inner.src, inner.dst, inner.rel = (inner.src[:e], inner.dst[:e],
                                           inner.rel[:e])

        def typed_step(state, batch, generator=None, group=None,
                       negatives=None):
            if negatives is not None:
                negatives = tuple(n[:, :e] for n in negatives)
            return step(state, batch, generator, group=group,
                        negatives=negatives)

        inner.train_step = typed_step
        return

    def train_step(state, batch, generator=None, group=None, **draws):
        mask = batch.edge_mask
        real = torch.cumsum(mask.long(), 0)
        half = mask & (real <= mask.sum() // 2)
        return step(state, batch._replace(edge_mask=half), generator,
                    group=group, **draws)

    inner.train_step = train_step


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
