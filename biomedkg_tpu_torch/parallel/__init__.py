"""Parallel strategies (counterpart of biomedkg_tpu/parallel/): the
(dp, tp) mesh of ranks (mesh.py), differentiable collectives
(collectives.py), the data-parallel and dp × tp steps (dp.py), the
tensor-parallel layout (sharding.py), the graph-sharded full-graph encode
and training step with the halo exchange (graph_shard.py), the row-sharded
typed step (typed_shard.py), one process per card (launch.py) and the
dry run of every strategy (dryrun.py).

The JAX package's exports (``make_mesh``, ``make_dp_train_step``,
``stack_batches``, and ``param_shard_dims`` for its
``kge_param_shardings``) load on first use: the training modules import
``parallel.mesh``, and ``dp`` imports the training modules."""

import importlib

_EXPORTS = {"make_mesh": "mesh", "make_dp_train_step": "dp",
            "stack_batches": "dp", "param_shard_dims": "sharding"}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
