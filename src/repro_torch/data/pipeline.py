"""Deterministic synthetic data pipeline (``repro.data.pipeline``).

The token stream is a pure function of ``(seed, step, host)``, so resume
after preemption replays it exactly. ``host_batch`` is numpy only and is
the JAX package's line for line: both packages see bit-identical tokens.
``DataIterator`` puts each batch on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"  # "uniform" | "markov" | "copy"
    mixture: Sequence[float] = (1.0,)


def _markov_tokens(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Order-1 markov stream with a sparse, learnable transition structure."""
    base = rng.integers(0, vocab, size=(batch,), dtype=np.int64)
    out = np.empty((batch, seq), dtype=np.int32)
    cur = base
    a, b = 31, 17
    for t in range(seq):
        noise = rng.integers(0, 4, size=(batch,))
        cur = (a * cur + b + noise) % vocab
        out[:, t] = cur
    return out


def _copy_tokens(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Copy task: the second half repeats the first half."""
    half = seq // 2
    first = rng.integers(0, vocab, size=(batch, half), dtype=np.int32)
    return np.concatenate([first, first[:, : seq - half]], axis=1)


def host_batch(cfg: DataConfig, step: int, host_index: int = 0, host_count: int = 1):
    """The (host-local) numpy batch for ``step``: a pure function of its inputs."""
    assert cfg.global_batch % host_count == 0
    local = cfg.global_batch // host_count
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, host_index]))
    if cfg.kind == "uniform":
        tokens = rng.integers(0, cfg.vocab_size, size=(local, cfg.seq_len + 1)).astype(np.int32)
    elif cfg.kind == "copy":
        tokens = _copy_tokens(rng, local, cfg.seq_len + 1, cfg.vocab_size)
    else:
        tokens = _markov_tokens(rng, local, cfg.seq_len + 1, cfg.vocab_size)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].astype(np.int32)}


class DataIterator:
    """Step-indexed iterator of ``{tokens, labels}`` int64 tensors on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: DataConfig, device="cuda", start_step: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = start_step

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        batch = host_batch(self.cfg, self.step)
        self.step += 1
        return {k: torch.from_numpy(v.astype(np.int64)).to(self.device, non_blocking=True)
                for k, v in batch.items()}
