"""Training-step scaffolding (counterpart of
biomedkg_tpu/training/stepping.py).

A module defines ``_forward_loss(batch, training, ...) -> (loss, aux)``;
this mixin supplies the train state, single steps, ``train_steps`` over a
list of batches and ``train_fullbatch`` over one batch (Python loops: the
counterparts of the reference's ``lax.scan``s; a CUDA-graph capture is
later work, ROADMAP.md queue 1, item 3), the eval steps (``_forward_loss``
with ``training=False`` under ``torch.inference_mode``, the aux reduced
on the device by the module's ``_reduce_eval_aux`` where it has one and
its ``eval_impl`` is "histogram"), the device-resident feature table
and ``fusion_fn``, the modules' fusion of multi-modal features.

Random numbers come from an explicit ``torch.Generator`` on the module's
device; keyword draws (the KGE module's ``negatives`` and
``dropout_masks``, the GCL modules' ``draws``) let a caller pass them in
instead (the tests inject the reference's, ROADMAP.md hazard H2).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.fusion import modality_mean
from .optim import AdamState, Optimizer


def mean_loss(outputs: List[Dict]) -> float:
    """The mean of eval outputs' float32 ``loss``es, taken in float64 on
    the host after one copy (0.0 for none), as the reference takes it."""
    if not outputs:
        return 0.0
    losses = torch.stack([o["loss"] for o in outputs]).double()
    return float(np.mean(losses.cpu().numpy()))


# leaves the reference's loss may leave ungraded, with a zero gradient
# there: ReDAF's sub-type table when no sub-type ids are given
UNGRADED = ("fusion.sub_type_emb.table",)


def param_grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]
                ) -> List[torch.Tensor]:
    """d loss / d params, in ``params``' order; zeros for an UNGRADED leaf
    the loss does not reach, and an error for any other."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    out = []
    for (name, p), g in zip(params.items(), grads):
        if g is None:
            if name not in UNGRADED:
                raise RuntimeError(f"the loss does not reach {name}")
            g = torch.zeros_like(p)
        out.append(g)
    return out


class TrainState(NamedTuple):
    """The module's parameters by name (updated in place by each step),
    the optimizer state and the number of steps taken."""
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: int


class StepsMixin:
    tx: Optional[Optimizer] = None
    feature_table: Optional[torch.Tensor] = None

    def _forward_loss(self, batch, training: bool, generator=None, **draws):
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def set_feature_table(self, x: np.ndarray) -> None:
        """Keep the full node-feature table on the module's device; batches
        then carry node ids only (the data module's
        ``device_features = True``)."""
        self.feature_table = torch.as_tensor(
            x, dtype=torch.float32).to(self.device)

    def _batch_features(self, batch) -> torch.Tensor:
        if batch.x.numel() == 0:
            if self.feature_table is None:
                raise ValueError("batch has no features; call "
                                 "set_feature_table first")
            return self.feature_table.index_select(0, batch.node_ids)
        return batch.x

    def fusion_fn(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                  training: bool = False) -> torch.Tensor:
        """(N, d) node features: the module's fuser (``self.fusion``) over
        (N, M, d) features, else their mean over the modality axis, else
        ``x`` as it is (N, d)."""
        if self.fusion is not None:
            return self.fusion(x, keep, training=training)
        return modality_mean(x)

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """A zero optimizer state over fresh weights from ``generator``,
        or over the module's current weights when it is None."""
        if self.tx is None:
            raise RuntimeError("call configure_optimizers first")
        if generator is not None:
            self.init(generator)
        params = dict(self.named_parameters())
        return TrainState(params, self.tx.init(list(params.values())), 0)

    def train_step(self, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, **draws):
        """One update; returns (state, {"train_loss": loss}), the loss a
        device scalar (reading it syncs). ``draws`` go to
        ``_forward_loss``."""
        params = list(state.params.values())
        loss, _ = self._forward_loss(batch, training=True,
                                     generator=generator, **draws)
        grads = param_grads(loss, state.params)
        opt_state = self.tx.update(grads, state.opt_state, params)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"train_loss": loss.detach()})

    def train_steps(self, state: TrainState, batches: List,
                    generator: torch.Generator):
        """len(batches) steps; returns (state, logs) with the last step's
        loss."""
        logs = {}
        for batch in batches:
            state, logs = self.train_step(state, batch, generator)
        return state, logs

    def train_fullbatch(self, state: TrainState, batch, generator,
                        num_steps: int):
        """``num_steps`` updates on one device batch; returns (state, the
        last step's loss)."""
        logs = {}
        for _ in range(num_steps):
            state, logs = self.train_step(state, batch, generator)
        return state, logs["train_loss"]

    def _maybe_reduce_eval(self, aux):
        reducer = getattr(self, "_reduce_eval_aux", None)
        if reducer is not None and \
                getattr(self, "eval_impl", "exact") == "histogram":
            return reducer(aux)
        return aux

    @torch.inference_mode()
    def eval_step(self, batch, generator: Optional[torch.Generator] = None,
                  **draws):
        """One held-out batch (no update); returns the aux dict, or its
        reduced metric state. ``draws`` go to ``_forward_loss``."""
        _, aux = self._forward_loss(batch, training=False,
                                    generator=generator, **draws)
        return self._maybe_reduce_eval(aux)

    def eval_steps(self, batches: List, generator: torch.Generator):
        """``eval_step`` over ``batches``, drawing from ``generator`` in
        turn; a list of their outputs."""
        return [self.eval_step(batch, generator) for batch in batches]
