"""Host input pipeline: worker processes, batching, copy to the card.

The port's :class:`DataLoader` of ``srbh_tpu/data/pipeline.py:32-137``,
built on train.py:113-130's ``torch.utils.data.DataLoader(num_workers=8,
pin_memory=True)``: the same index order (a ``default_rng(seed + epoch)``
shuffle), the same ``set_epoch`` call on the dataset at the start of every
epoch (before the epoch's workers start, so each holds that epoch), and
batches of stacked samples (the last one may be short, or with
``drop_last`` is left out). ``num_workers``
processes load the samples. With ``device_put`` the batches are collated
into pinned host tensors when ``device`` (``None`` is the card) is a card,
and copied to it with ``non_blocking=True``, but for ``path`` and the keys
named in ``host_keys``, which stay on the host. A worker's exception is
raised again in the consumer, and an epoch that ends short of ``len(loader)``
batches raises: torch's loader ends an epoch without a word where a
sample's ``__getitem__`` raises ``StopIteration``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from srbh_tpu_torch import resolve_device


class _EpochOrder(torch.utils.data.Sampler):
    """The sample indices of epoch ``epoch``: ``default_rng(seed + epoch)``
    shuffles them, as the JAX loader does."""

    def __init__(self, n: int, shuffle: bool, seed: int):
        self.n, self.shuffle, self.seed, self.epoch = n, shuffle, seed, 0

    def __len__(self):
        return self.n

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return iter(idx.tolist())


class DataLoader:
    """Iterable over batched sample dicts of tensors (``path`` a list),
    loaded by ``num_workers`` processes (0 = in the calling process)."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 1337,
                 device_put: bool = False, device=None,
                 host_keys: Sequence[str] = (), drop_last: bool = False):
        self.dataset = dataset
        self.host_keys = ("path", *host_keys)
        self.device = resolve_device(device) if device_put else None
        self.epoch = 0
        self._order = _EpochOrder(len(dataset), shuffle, seed)
        self._loader = torch.utils.data.DataLoader(
            dataset, batch_size=batch_size, sampler=self._order,
            num_workers=num_workers, drop_last=drop_last,
            pin_memory=self.device is not None and self.device.type == "cuda")

    def __len__(self):
        return len(self._loader)

    def __iter__(self) -> Iterator[Dict]:
        self._order.epoch = self.epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        self.epoch += 1
        n = 0
        for batch in self._loader:
            if self.device is not None:
                batch = {k: v if k in self.host_keys else
                         v.to(self.device, non_blocking=True)
                         for k, v in batch.items()}
            n += 1
            yield batch
        if n != len(self):
            raise RuntimeError(f"epoch {self.epoch - 1} ended after {n} of "
                               f"{len(self)} batches")
