"""Paged KV-cache block pool for the serving engine.

The dense engine reserved one ``max_len``-long KV strip per slot, so
HBM — not compute — capped concurrency at ``max_slots`` regardless of
how short the resident requests actually were.  This module provides the
block-granular allocator that converts that ceiling into *actual tokens
in flight*: physical KV pages of ``block_size`` tokens live in one
shared pool (``models.layers.init_kv_pages``), and each request owns an
ordered list of block ids — its *block table* — mapping logical token
blocks to physical pages.

Host-side bookkeeping only: the pool tracks free ids and refcounts; the
device-side page tensors are owned by the engine's cache pytree and are
indexed by the block tables this allocator hands out.

Semantics
---------
* ``alloc(n)`` pops ``n`` ids off a LIFO free list (fixed-size blocks
  mean reuse is fragmentation-free by construction) with refcount 1, or
  raises :class:`PoolExhausted` without side effects.
* ``free(ids)`` decrements refcounts and returns ids whose count hits
  zero to the free list.
* ``incref(ids)`` / ``share(ids)`` support shared pages (detached
  preempted requests, radix prefix-cache chains): a page is reclaimed
  only when every owner has released it.
* ``fork(id)`` is the copy-on-write primitive: before WRITING to a page
  some other owner can still read, the writer trades its reference for
  a fresh private page (the caller copies the device bytes); a page
  with a single owner is returned unchanged — no copy, no alloc.
* ``assert_consistent()`` is the accounting invariant every engine stats
  path checks: free + refcounted == total, and no free page holds a
  reference.  Any alloc/share/fork/free interleaving must preserve it.
"""
from __future__ import annotations

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised by ``alloc`` when fewer free blocks exist than requested."""


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Number of ``block_size``-token pages covering ``n_tokens``."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_size)


def page_bytes(cfg, block_size: int, kv_dtype=None) -> int:
    """Device bytes of ONE physical page across all stacked pool layers
    for the given quant layout.

    f32 layout: K and V at 4 bytes/element.  ``kv_dtype="int8"``: K/V at
    1 byte plus one f32 scale per (token offset, kv head) — an overhead
    of ``4 / head_dim`` relative to the int8 bytes, so the page shrinks
    ~3.8x at head_dim 64 (the capacity lever the admission ceiling
    sees).  Only GLOBAL attention layers hold pages; callers that mix
    dense ring layers (gemma patterns) account those separately.
    """
    n_global = sum(1 for i in range(cfg.num_layers)
                   if cfg.pattern_period <= 1
                   or (i + 1) % cfg.pattern_period == 0)
    per_tok = block_size * cfg.num_kv_heads
    if kv_dtype == "int8":
        elem = per_tok * cfg.head_dim * 1 + per_tok * 4   # int8 + f32 scale
    elif kv_dtype is None:
        elem = per_tok * cfg.head_dim * 4
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    return 2 * elem * max(n_global, 1)                     # K and V


def pool_blocks_for_budget(cfg, block_size: int, budget_bytes: int,
                           kv_dtype=None) -> int:
    """How many pool pages fit in ``budget_bytes`` of device memory for
    the given quant layout — the fixed-HBM capacity comparison the
    quantized-serving benchmark reports (int8 vs f32 concurrent slots
    at identical pool bytes)."""
    pb = page_bytes(cfg, block_size, kv_dtype)
    return max(0, int(budget_bytes) // pb)


class KVBlockPool:
    """Fixed-size KV page allocator with refcounts (host-side)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO: freshly freed pages are reused first (cache-warm reuse)
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self._refcount = np.zeros(self.num_blocks, np.int32)
        # traffic counters, live only after attach_metrics (telemetry)
        self._m_alloc = self._m_share = None
        self._m_fork = self._m_reclaim = None

    # ------------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def num_shared(self) -> int:
        """Pages with more than one owner right now — prefix-cache
        chains pinned by readers, in-flight published frontiers,
        detached preemption twins.  Observability for how much KV the
        sharing machinery is actually deduplicating."""
        return int((self._refcount > 1).sum())

    def refcount(self, block_id: int) -> int:
        return int(self._refcount[block_id])

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def attach_metrics(self, registry) -> None:
        """Register this pool's occupancy gauges and traffic counters
        into a ``serving.telemetry.MetricsRegistry``: occupancy
        (``kv_pool.blocks/free/used/shared``) samples the live pool at
        collect time; traffic (``kv_pool.alloc/share/fork_copy/
        reclaimed_blocks``) counts page movements, bumped by
        alloc/share/fork/free themselves."""
        registry.gauge("kv_pool.blocks", lambda: self.num_blocks)
        registry.gauge("kv_pool.free", lambda: self.num_free)
        registry.gauge("kv_pool.used", lambda: self.num_used)
        registry.gauge("kv_pool.shared", lambda: self.num_shared)
        self._m_alloc = registry.counter("kv_pool.alloc_blocks")
        self._m_share = registry.counter("kv_pool.share_blocks")
        self._m_fork = registry.counter("kv_pool.fork_copies")
        self._m_reclaim = registry.counter("kv_pool.reclaimed_blocks")

    # ------------------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        """Claim ``n`` blocks (refcount 1 each) or raise PoolExhausted.

        All-or-nothing: on failure the pool is untouched, so admission
        can probe feasibility without cleanup.
        """
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, only {len(self._free)} of "
                f"{self.num_blocks} free")
        ids = [self._free.pop() for _ in range(n)]
        self._refcount[ids] += 1
        if self._m_alloc is not None:
            self._m_alloc.inc(n)
        return ids

    def incref(self, block_ids) -> None:
        for b in block_ids:
            if self._refcount[b] <= 0:
                raise ValueError(f"incref on unallocated block {b}")
            self._refcount[b] += 1
            if self._m_share is not None:
                self._m_share.inc()

    # prefix sharing reads as "share these pages with one more owner"
    share = incref

    def fork(self, block_id: int) -> int:
        """Copy-on-write: give the caller a PRIVATE page id in exchange
        for its reference on ``block_id``.

        With refcount 1 the caller already owns the page exclusively —
        it is returned unchanged.  Otherwise one fresh page is allocated
        (refcount 1), the caller's reference on the shared page is
        dropped, and the new id is returned; the caller is responsible
        for copying the device-side page contents old -> new.  Raises
        :class:`PoolExhausted` (pool untouched) when no page is free.
        """
        if self._refcount[block_id] <= 0:
            raise ValueError(f"fork of unallocated block {block_id}")
        if self._refcount[block_id] == 1:
            return int(block_id)
        (new,) = self.alloc(1)
        self._refcount[block_id] -= 1
        if self._m_fork is not None:
            self._m_fork.inc()
        return new

    def free(self, block_ids) -> None:
        """Release one reference per id; zero-ref pages return to the
        free list (in order, so tests can assert deterministic reuse)."""
        for b in block_ids:
            if self._refcount[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                self._free.append(int(b))
                if self._m_reclaim is not None:
                    self._m_reclaim.inc()

    # ------------------------------------------------------------------
    def assert_consistent(self) -> None:
        """Accounting invariant: every page is either on the free list
        (refcount 0) or referenced (refcount > 0) — never both, never
        neither.  Raises RuntimeError with the drift details."""
        n_ref = int((self._refcount > 0).sum())
        if len(self._free) + n_ref != self.num_blocks:
            raise RuntimeError(
                f"pool accounting drift: free {len(self._free)} + "
                f"refcounted {n_ref} != total {self.num_blocks}")
        if len(set(self._free)) != len(self._free):
            raise RuntimeError("pool free list contains duplicates")
        bad = [b for b in self._free if self._refcount[b] != 0]
        if bad:
            raise RuntimeError(f"free blocks with live refcount: {bad}")

    # ------------------------------------------------------------------
    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"KVBlockPool(blocks={self.num_blocks}, "
                f"block_size={self.block_size}, free={self.num_free})")
