"""Loaders (counterpart of biomedkg_tpu/sampling/loaders.py):
``SaintRandomWalkLoader`` (KGE training batches), ``NeighborBatchLoader``
(fan-out batches, sampling/neighbor.py), ``FullGraphLoader`` (the whole
graph as one padded batch, for full-batch training, serving and export),
and the background prefetch the Trainer runs its loops on: ``prefetch``
(an iterator on a thread, a bounded queue) and ``prefetch_to_device``
(the same thread also copies each item to the card).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..utils import profiling
from .batch import GraphBatch, batch_to_device, pad_graph_batch
from .csr import CSRGraph
from .neighbor import NeighborBatchLoader  # noqa: F401  (re-exported)
from .saint import SaintRandomWalkSampler, _round_up


# the reference's loader name; one epoch = num_steps batches
SaintRandomWalkLoader = SaintRandomWalkSampler


class FullGraphLoader:
    """Single padded batch containing the entire graph."""

    def __init__(self, graph: CSRGraph, block_size: int = 256,
                 edge_layout: str = "relation"):
        self.graph = graph
        self.block_size = block_size
        self.edge_layout = edge_layout
        self._batch = None

    def batch(self) -> GraphBatch:
        if self._batch is None:
            g = self.graph
            counts = np.bincount(g.edge_type, minlength=g.num_relations)
            edge_budget = int(np.sum(
                (counts + self.block_size - 1) // self.block_size
            ) * self.block_size)
            edge_budget = max(edge_budget, self.block_size)
            # the reference aligns to lcm(block_size, 2048) for its
            # training-side negative chunks; kept so both packages pack the
            # same envelope
            lcm = int(np.lcm(self.block_size, 2048))
            edge_budget = -(-edge_budget // lcm) * lcm
            x = g.x if g.x is not None else np.zeros((g.num_nodes, 1),
                                                     np.float32)
            self._batch = pad_graph_batch(
                x, g.edge_index, g.edge_type, num_relations=g.num_relations,
                node_budget=_round_up(g.num_nodes + 1, 128),
                edge_budget=edge_budget, block_size=self.block_size,
                num_seed=g.num_nodes,
                node_ids=np.arange(g.num_nodes, dtype=np.int32),
                layout=self.edge_layout)
        return self._batch

    def __iter__(self):
        yield self.batch()

    def __len__(self):
        return 1


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Run ``iterable`` on a daemon thread, at most ``size`` items ahead.

    An exception in the worker is raised in the consumer after the items
    before it. Leaving the generator early (``break``) stops the worker,
    drains the queue and joins the thread, so no thread stays blocked on
    ``put`` holding batches. A generator given as ``iterable`` is closed on
    the worker's thread. The consumer's blocking get is the
    ``trainer.wait`` span."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    error: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    break
        except BaseException as e:  # raised again in the consumer
            error.append(e)
        finally:
            close = getattr(iterable, "close", None)
            if close is not None:
                close()
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with profiling.span("trainer.wait"):
                item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join()


def _copy_tree(tree, copy, memo: dict):
    """Every host ``GraphBatch`` in ``tree`` (tuples and lists of them)
    through ``copy``; a batch met just before (by identity: the full-batch
    loader yields one object ``steps`` times) is copied once."""
    if isinstance(tree, GraphBatch):
        if id(tree) not in memo:
            memo.clear()
            memo[id(tree)] = (tree, copy(tree))
        return memo[id(tree)][1]
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy_tree(t, copy, memo) for t in tree)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _tensors(item)


def prefetch_to_device(iterable: Iterable, device, size: int = 2
                       ) -> Iterator:
    """``prefetch`` whose worker also copies every host ``GraphBatch`` of
    each item (a batch, or tuples and lists holding batches) to
    ``device``, each item's copy a ``prefetch.copy`` span counting the
    host bytes copied (``bytes``).

    On the card the worker copies from pinned memory on a side CUDA stream
    and records an event after each item; the consumer's stream waits on
    that event (the host does not) before the item is yielded, and each of
    its tensors is marked as used on the consumer's stream
    (``record_stream``), so the caching allocator does not hand its memory
    to a later copy while a step still reads it. On the CPU it is
    ``batch_to_device`` on the worker's thread."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    memo: dict = {}

    def copy(b: GraphBatch) -> GraphBatch:
        if profiling.ON:
            profiling.count("bytes", sum(np.asarray(a).nbytes for a in b))
        return batch_to_device(b, device, pinned=cuda)

    side = torch.cuda.Stream(device) if cuda else None

    def copied():
        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            for item in iterable:
                with profiling.span("prefetch.copy", counters=("bytes",)):
                    moved = _copy_tree(item, copy, memo)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(side)
                yield moved, event

    if not cuda:
        for moved, _ in prefetch(copied(), size=size):
            yield moved
        return
    consumer = torch.cuda.current_stream(device)
    for moved, event in prefetch(copied(), size=size):
        consumer.wait_event(event)
        for t in _tensors(moved):
            t.record_stream(consumer)
        yield moved
