"""Host input pipeline: worker processes, batching, copy to the card.

The port's :class:`DataLoader` of ``srbh_tpu/data/pipeline.py:32-137``,
built on train.py:113-130's ``torch.utils.data.DataLoader(num_workers=8,
pin_memory=True)``: the same index order (a ``default_rng(seed + epoch)``
shuffle), the same ``set_epoch`` call on the dataset at the start of every
epoch (before the epoch's workers start, so each holds that epoch), and
batches of stacked samples (the last one may be short, or with
``drop_last`` is left out). With ``num_shards`` > 1 the loader reads only
shard ``shard_index`` of each epoch's order, ``idx[shard_index::num_shards]``
cut to ``len(dataset) // num_shards`` samples so every shard is as long (a
rank with one batch more would leave the others waiting in a collective):
the JAX loader's split. Shard ``r``'s ``k``-th batch of ``b`` is then the
rows ``r, r + n, ...`` of the single loader's ``k``-th batch of ``n x b``.
``num_workers``
processes load the samples. With ``device_put`` the batches are collated
into pinned host tensors when ``device`` (``None`` is the card) is a card,
and copied to it with ``non_blocking=True``, but for ``path`` and the keys
named in ``host_keys``, which stay on the host. Up to ``prefetch`` batches
(default 2; the JAX loader's bound, which refuses values below 1) are issued
to the card ahead of the one the consumer holds, so a batch's copy overlaps
the step on the batch before it; the batches and their order stay the same.
A worker's exception is raised again in the consumer, and an epoch that
ends short of ``len(loader)`` batches raises: torch's loader ends an epoch
without a word where a sample's ``__getitem__`` raises ``StopIteration``.
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from srbh_tpu_torch import resolve_device
from srbh_tpu_torch.utils import profiler


class _EpochOrder(torch.utils.data.Sampler):
    """The sample indices of epoch ``epoch``: ``default_rng(seed + epoch)``
    shuffles them, as the JAX loader does."""

    def __init__(self, n: int, shuffle: bool, seed: int, shard_index: int = 0,
                 num_shards: int = 1):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} of {num_shards}")
        self.n, self.shuffle, self.seed, self.epoch = n, shuffle, seed, 0
        self.shard_index, self.num_shards = shard_index, num_shards

    def __len__(self):
        return self.n // self.num_shards if self.num_shards > 1 else self.n

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return iter(idx[self.shard_index::self.num_shards][:len(self)].tolist())


class DataLoader:
    """Iterable over batched sample dicts of tensors (``path`` a list),
    loaded by ``num_workers`` processes (0 = in the calling process)."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 1337,
                 device_put: bool = False, device=None,
                 host_keys: Sequence[str] = (), drop_last: bool = False,
                 shard_index: int = 0, num_shards: int = 1, prefetch: int = 2):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.prefetch = prefetch
        self.dataset = dataset
        self.host_keys = ("path", *host_keys)
        self.device = resolve_device(device) if device_put else None
        self.epoch = 0
        self._order = _EpochOrder(len(dataset), shuffle, seed, shard_index,
                                  num_shards)
        self._loader = torch.utils.data.DataLoader(
            dataset, batch_size=batch_size, sampler=self._order,
            num_workers=num_workers, drop_last=drop_last,
            pin_memory=self.device is not None and self.device.type == "cuda")

    def __len__(self):
        return len(self._loader)

    def __iter__(self) -> Iterator[Dict]:
        # the span ``loader.start``: the worker processes' start and the
        # first ``prefetch + 1`` batches, up to (never across) the first yield
        with profiler.span("loader.start"):
            self._order.epoch = self.epoch
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(self.epoch)
            self.epoch += 1
            batches = iter(self._loader)
            # batches issued, not yet handed out
            ahead = collections.deque(self._put(b) for b in itertools.islice(
                batches, self.prefetch + 1))
        n, more = 0, len(ahead) > self.prefetch
        while ahead:
            n += 1
            yield ahead.popleft()
            if more:  # the next batch, if the epoch has one
                batch = next(batches, None)
                more = batch is not None
                if more:
                    ahead.append(self._put(batch))
        if n != len(self):
            raise RuntimeError(f"epoch {self.epoch - 1} ended after {n} of "
                               f"{len(self)} batches")

    def _put(self, batch: Dict) -> Dict:
        """``batch`` with its tensors issued to the device (``device_put``),
        but for the host keys."""
        if self.device is None:
            return batch
        return {k: v if k in self.host_keys else
                v.to(self.device, non_blocking=True)
                for k, v in batch.items()}
