"""Token data pipeline (port of ``repro/data/pipeline.py``): a
deterministic synthetic corpus, greedy sequence packing with EOS
separators, batching, and device placement.

The corpus, the packing and the batch order are numpy, as in the JAX
package, so one seed gives bitwise the same documents, rows and batches
in both. ``shard_batch`` puts a host batch on a device, or lays it out by
one of ``core/resharding.py``'s layouts where JAX takes a sharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_map


@dataclass
class TokenStream:
    """Bounded random-access view over a token corpus."""

    tokens: np.ndarray            # (n,) int32

    def __len__(self):
        return len(self.tokens)

    def window(self, start: int, length: int) -> np.ndarray:
        idx = (start + np.arange(length)) % len(self.tokens)
        return self.tokens[idx]


class SyntheticLMDataset:
    """Deterministic synthetic documents with local n-gram structure, so a
    model trained on it has signal (its loss falls)."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 mean_doc_len: int = 512):
        self.vocab_size = vocab_size
        self.rng = np.random.default_rng(seed)
        self.mean_doc_len = mean_doc_len

    def documents(self, n_docs: int) -> List[np.ndarray]:
        docs = []
        for _ in range(n_docs):
            length = max(8, int(self.rng.poisson(self.mean_doc_len)))
            # Markovian tokens: next = (prev * a + noise) % V -> learnable
            a = int(self.rng.integers(3, 17))
            toks = np.zeros(length, np.int32)
            toks[0] = int(self.rng.integers(1, self.vocab_size))
            noise = self.rng.integers(0, 7, size=length)
            for i in range(1, length):
                toks[i] = ((toks[i - 1] * a + noise[i])
                           % (self.vocab_size - 1) + 1)
            docs.append(toks)
        return docs


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   eos_id: int = 0) -> np.ndarray:
    """Greedy packing into (n_rows, seq_len) int32 with EOS separators;
    the last row is padded with EOS."""
    rows, cur = [], []
    cur_len = 0
    for d in docs:
        d = np.concatenate([d, [eos_id]])
        while len(d) > 0:
            take = min(seq_len - cur_len, len(d))
            cur.append(d[:take])
            cur_len += take
            d = d[take:]
            if cur_len == seq_len:
                rows.append(np.concatenate(cur))
                cur, cur_len = [], 0
    if cur_len > 0:
        pad = np.full(seq_len - cur_len, eos_id, np.int32)
        rows.append(np.concatenate(cur + [pad]))
    return np.stack(rows).astype(np.int32)


def make_batches(rows: np.ndarray, batch_size: int, *,
                 drop_remainder: bool = True,
                 shuffle_seed: Optional[int] = None) -> Iterator[np.ndarray]:
    """Batches of ``rows`` in order, or in the order a numpy generator
    seeded with ``shuffle_seed`` shuffles them."""
    n = len(rows)
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        yield rows[order[i:i + batch_size]]


def shard_batch(batch, device=None, layout=None):
    """Place a host batch (a numpy array or a tree of them) on ``device``
    (``None``: the GPU, raising without one). With ``layout`` (a
    ``resharding.NamedLayout``), each array is laid out by it: this rank
    keeps its shard (``NamedLayout.local_shard``), a rank outside the
    layout's mesh a meta tensor of the global shape."""
    dev = resolve_device(device)

    def place(x):
        t = torch.as_tensor(np.asarray(x)).to(dev)
        return t if layout is None else layout.local_shard(t)

    return tree_map(place, batch)
