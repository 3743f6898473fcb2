"""Paged KV-cache bookkeeping: refcounted block pool, per-slot block
tables, layout-driven slot reset, and host-side swap-out
(``repro.serve.kv_cache``).

The device side of the paged cache lives in ``models.transformer``
(``init_paged_cache`` / ``paged_cache_layout``) and ``models.attention``
(``PagedKVCache``, ``paged_attention_apply``). This module is the host
side the engine programs against:

* :class:`BlockAllocator`: a refcounted free list over physical blocks
  ``1 .. n_blocks-1``. Block 0 is the reserved null block: masked writes
  go there and it is never handed to a request. ``alloc`` is
  all-or-nothing; double frees and foreign frees raise.
* :class:`BlockTables`: the host mirror of the ``(n_slots, max_blocks)``
  int32 table (0-padded past each slot's allocation).
* :func:`reset_slot`: zero one slot's per-slot cache rows, by the
  :class:`~repro_torch.models.transformer.CacheLeafLayout` metadata, in
  place. Pool leaves are never reset: unique block ownership and the
  position mask isolate the requests.
* :class:`SwapPool` with :func:`gather_slot_kv` / :func:`scatter_slot_kv`:
  preemption. Swap-out copies a victim's physical blocks (every ``pool``
  leaf, block axis ``ndim - 4``) and its ``state`` rows to host numpy
  buffers, checksums them and frees the device blocks; restore writes the
  same bytes into freshly allocated blocks. Attention reads the pool
  through the block table, so the physical ids may change across the
  round trip, and the round trip is bit-exact. bf16 has no numpy dtype:
  its buffers are ``uint16`` views of the same bits, so the checksum
  covers exactly the device bytes. The checksum is verified before any
  device write, so a corrupted snapshot fails only its request.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import tree
from .lifecycle import SwapCorruptError

NULL_BLOCK = 0


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Blocks required to hold ``n_tokens`` cache positions."""
    return -(-n_tokens // block_size)


class BlockAllocator:
    """Refcounted free-list allocator over physical blocks ``1 .. n_blocks-1``.

    ``alloc`` is all-or-nothing (None when the request cannot be met), so
    admission can reserve a request's worst case up front. Blocks come back
    at refcount 1; ``incref`` adds sharers, ``free`` decrements and
    recycles at zero. Double frees and foreign frees raise.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.n_blocks = n_blocks
        # LIFO free list: recently freed blocks are re-used first
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, k: int) -> Optional[List[int]]:
        """Reserve ``k`` blocks at refcount 1; None if fewer are free."""
        if k < 0:
            raise ValueError(f"alloc({k})")
        if k > len(self._free):
            return None
        out = [self._free.pop() for _ in range(k)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        """Add a sharer to already-allocated blocks."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"incref of unallocated block {b}")
        for b in blocks:
            self._ref[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"free of unallocated block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)


class BlockTables:
    """Host mirror of the per-slot block-table operand: ``array`` is the
    ``(n_slots, max_blocks)`` int32 ndarray, rows 0-padded (the null
    block) past each slot's allocation."""

    def __init__(self, n_slots: int, max_blocks: int):
        self.n_slots = n_slots
        self.max_blocks = max_blocks
        self.array = np.zeros((n_slots, max_blocks), np.int32)
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]

    def assign(self, slot: int, blocks: Sequence[int]) -> None:
        if len(blocks) > self.max_blocks:
            raise ValueError(f"{len(blocks)} blocks > table width {self.max_blocks}")
        if self._owned[slot]:
            raise ValueError(f"slot {slot} already holds blocks")
        self._owned[slot] = list(blocks)
        self.array[slot, :] = NULL_BLOCK
        self.array[slot, : len(blocks)] = blocks

    def release(self, slot: int) -> List[int]:
        """Clear the slot's row; returns the blocks for the allocator."""
        blocks = self._owned[slot]
        self._owned[slot] = []
        self.array[slot, :] = NULL_BLOCK
        return blocks

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])


def reset_slot(caches, layouts, slot: int):
    """Zero slot ``slot``'s rows of every per-slot cache leaf, in place, and
    return ``caches``. ``layouts`` is the matching layout tree
    (``transformer.cache_layout`` / ``paged_cache_layout``); leaves whose
    layout has no slot axis (pool, shared index) are left alone. Resets
    slot-indexed leaves of any dtype."""
    for leaf, lay in zip(tree.leaves(caches), tree.leaves(layouts)):
        if lay.slot_axis is not None:
            leaf.select(lay.slot_axis, slot).zero_()
    return caches


# ------------------------------------------------------------------ swap-out


def _pool_block_axis(leaf) -> int:
    """Block axis of a pool leaf, whose trailing dims are ``(n_blocks,
    block_size, kv_heads, head_dim)`` behind any stacked repeat axes."""
    return leaf.ndim - 4


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` with its exact bits (bf16 as uint16)."""
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` (from :func:`_to_host`) as a tensor of ``like``'s dtype and
    device, bit for bit."""
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(like.device)


def gather_slot_kv(caches, layouts, slot: int, phys_blocks: Sequence[int]):
    """Host numpy snapshot of one slot: ``(pool_rows, state_rows)``.

    ``pool_rows`` holds, per pool leaf, the contents of the slot's
    physical blocks in logical (block-table) order; ``state_rows`` each
    per-slot state leaf's row for ``slot``. Both keep the device bits."""
    pool_rows, state_rows = [], []
    for leaf, lay in zip(tree.leaves(caches), tree.leaves(layouts)):
        if lay.role == "pool":
            idx = torch.as_tensor(list(phys_blocks), dtype=torch.long, device=leaf.device)
            pool_rows.append(_to_host(leaf.index_select(_pool_block_axis(leaf), idx)))
        elif lay.role == "state":
            state_rows.append(_to_host(leaf.select(lay.slot_axis, slot)))
    return pool_rows, state_rows


def scatter_slot_kv(caches, layouts, slot: int, phys_blocks: Sequence[int],
                    pool_rows: List[np.ndarray], state_rows: List[np.ndarray]):
    """Inverse of :func:`gather_slot_kv` onto (possibly different)
    physical blocks, in place: each pool snapshot goes to ``phys_blocks``
    in logical order and each state row to ``slot``. Returns ``caches``."""
    pi = si = 0
    for leaf, lay in zip(tree.leaves(caches), tree.leaves(layouts)):
        if lay.role == "pool":
            idx = torch.as_tensor(list(phys_blocks), dtype=torch.long, device=leaf.device)
            leaf.index_copy_(_pool_block_axis(leaf), idx, _to_device(pool_rows[pi], leaf))
            pi += 1
        elif lay.role == "state":
            leaf.select(lay.slot_axis, slot).copy_(_to_device(state_rows[si], leaf))
            si += 1
    return caches


def snapshot_checksum(buffers: Sequence[np.ndarray]) -> int:
    """CRC32 over the concatenated raw bytes of the snapshot buffers."""
    crc = 0
    for b in buffers:
        crc = zlib.crc32(np.ascontiguousarray(b).tobytes(), crc)
    return crc


@dataclasses.dataclass
class SwapRecord:
    """One preempted request's restorable host-side snapshot."""

    uid: int
    n_blocks: int                  # blocks to re-allocate on restore
    pool_rows: List[np.ndarray]    # per pool leaf, logical block order
    state_rows: List[np.ndarray]   # per state leaf, the slot's row
    checksum: int                  # CRC over pool_rows + state_rows
    # engine progress snapshot
    slot_len: int
    prefill_pos: int
    remaining: int
    phase: str                     # "prefill" | "decode"

    def verify(self) -> None:
        """Raise :class:`SwapCorruptError` if the snapshot no longer
        matches its recorded checksum (called before any device write)."""
        actual = snapshot_checksum(self.pool_rows + self.state_rows)
        if actual != self.checksum:
            raise SwapCorruptError(self.uid, self.checksum, actual)


class SwapPool:
    """Bounded, insertion-ordered store of :class:`SwapRecord`. The engine
    restores in FIFO order; a full pool makes the next preemption a kill
    (terminal ``PREEMPTED``) instead of growing host memory."""

    def __init__(self, max_records: Optional[int] = None):
        self.max_records = max_records
        self._records: Dict[int, SwapRecord] = {}

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, uid: int) -> bool:
        return uid in self._records

    @property
    def full(self) -> bool:
        return self.max_records is not None and len(self) >= self.max_records

    def put(self, rec: SwapRecord) -> None:
        if self.full:
            raise RuntimeError(f"swap pool full ({self.max_records} records)")
        if rec.uid in self._records:
            raise ValueError(f"request {rec.uid} already swapped")
        self._records[rec.uid] = rec

    def peek_first(self) -> Optional[SwapRecord]:
        for rec in self._records.values():
            return rec
        return None

    def pop(self, uid: int) -> SwapRecord:
        return self._records.pop(uid)

    def host_bytes(self) -> int:
        return sum(b.nbytes for rec in self._records.values()
                   for b in rec.pool_rows + rec.state_rows)
