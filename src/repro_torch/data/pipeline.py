"""Deterministic, checkpointable, sharded synthetic-token data pipeline.

A copy of the reference's ``repro.data.pipeline``, in numpy as there: the
same documents from ``np.random.default_rng((seed, index))``, so both
packages train on the same batches, bit for bit.

  * a ``TokenSource`` produces documents deterministically from (seed, index)
    — a stand-in for a tokenized corpus shard; swap in a memory-mapped
    array source for real data (same interface).
  * ``PackedLMDataset`` packs documents into fixed (seq_len+1) windows with
    next-token labels.
  * ``DataIterator`` is stateful and *checkpointable* (its cursor rides in
    every checkpoint, so restarts resume mid-epoch exactly).
  * sharding: each data-parallel worker reads only its slice, matching the
    (M, B/M, ...) microbatched global layout the trainer consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

PAD = -1  # label id for masked positions


class TokenSource:
    """Deterministic document stream: doc i is reproducible from (seed, i)."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 min_len: int = 32, max_len: int = 512):
        self.vocab_size = vocab_size
        self.seed = seed
        self.min_len = min_len
        self.max_len = max_len

    def doc(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        n = int(rng.integers(self.min_len, self.max_len + 1))
        # zipf-ish marginal over the vocab (realistic token frequencies)
        z = rng.zipf(1.3, size=n)
        return np.minimum(z, self.vocab_size - 1).astype(np.int32)


@dataclasses.dataclass
class IteratorState:
    doc_cursor: int
    buffer: np.ndarray  # leftover tokens from the last packed document

    def to_dict(self) -> Dict:
        return {"doc_cursor": int(self.doc_cursor), "buffer": self.buffer.tolist()}

    @staticmethod
    def from_dict(d: Dict) -> "IteratorState":
        return IteratorState(int(d["doc_cursor"]), np.asarray(d["buffer"], np.int32))


class PackedLMDataset:
    """Packs the document stream into (tokens, labels) training windows."""

    def __init__(self, source: TokenSource, seq_len: int):
        self.source = source
        self.seq_len = seq_len

    def fill(self, state: IteratorState, n_windows: int) -> Tuple[np.ndarray, np.ndarray, IteratorState]:
        need = n_windows * (self.seq_len + 1)
        buf = state.buffer
        cursor = state.doc_cursor
        parts = [buf]
        total = len(buf)
        while total < need:
            d = self.source.doc(cursor)
            cursor += 1
            parts.append(d)
            total += len(d)
        stream = np.concatenate(parts)
        used, rest = stream[:need], stream[need:]
        w = used.reshape(n_windows, self.seq_len + 1)
        tokens = w[:, :-1].copy()
        labels = w[:, 1:].copy()
        return tokens, labels, IteratorState(cursor, rest.astype(np.int32))


class DataIterator:
    """Sharded, stateful iterator emitting the trainer's global batch layout.

    Emits {tokens, labels} with shape (M, B/M, seq_len) — already microbatched
    (see train_step.accumulate_grads).  With ``shard_index/shard_count`` set,
    only the host's slice of the batch is materialized (multi-host input
    pipeline); on a single host the full global batch is produced.
    """

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        num_microbatches: int,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        assert global_batch % num_microbatches == 0
        self.dataset = PackedLMDataset(
            TokenSource(vocab_size, seed=seed * 1000 + shard_index), seq_len
        )
        self.global_batch = global_batch
        self.m = num_microbatches
        self.shard_count = shard_count
        self.state = IteratorState(0, np.zeros((0,), np.int32))

    def __iter__(self) -> "DataIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = self.global_batch // self.shard_count
        tokens, labels, self.state = self.dataset.fill(self.state, n)
        mb = self.global_batch // self.m
        mb_local = mb // self.shard_count
        tokens = tokens.reshape(self.m, mb_local, -1)
        labels = labels.reshape(self.m, mb_local, -1)
        return {"tokens": tokens, "labels": labels}

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def load_state_dict(self, d: Dict) -> None:
        self.state = IteratorState.from_dict(d)
