"""Radix-tree prefix cache over the paged KV pool (PyTorch port of
``repro.serving.prefix_cache``; host-side, so the same code).

The EdgeAI-Hub premise — shared resources across users instead of
per-device duplication — applied inside the serving engine: every
household request carries the same system/persona prefix, and with a
paged KV cache those prefix pages can be SHARED by reference instead of
re-prefilled and re-stored per request.

This module is the host-side index that makes the sharing findable: a
radix tree mapping token-id prefixes to page chains at TOKEN
granularity.  Full ``block_size``-token pages are shared zero-copy
(suffix writes land past them); a match that ends mid-page — a partial
final block, either because the query diverges inside a cached page or
because the cached chain itself ends mid-page — is still returned, and
the ENGINE copy-on-write-forks that one page (``KVBlockPool.fork`` +
device page copy) so its suffix writes never touch the shared copy.
Tree structure stays block-aligned: edges split only on page
boundaries, and an edge whose key length is not a page multiple is
always a leaf (a finished chain's partial tail page, adopted verbatim).

Ownership protocol (mirrors vLLM/SGLang)
----------------------------------------
* The cache holds exactly ONE pool reference per indexed page.
* ``match(key)`` walks the tree, bumps LRU stamps, and increfs every
  matched page **on behalf of the reader** — the engine then owns those
  pages like any allocation (frees on finish, detaches on preempt).
* ``insert(key, blocks)`` adopts the caller's references for pages that
  extend the tree and returns the caller's now-duplicate ids (prefix
  already indexed, possibly under different physical pages) for the
  caller to free.  Inserting never allocates.  A chain that diverges
  from a resident chain in the MIDDLE of a page cannot be keyed apart
  in a radix over pages — the resident chain wins and the incoming
  tail is returned unadopted.  A chain that extends a resident partial
  tail replaces that tail page (the cache releases its own reference on
  the superseded page) and adopts the longer chain.
* ``evict(n)`` releases LRU leaf chains whose pages have pool refcount
  1 (the cache is the sole owner — nothing active reads them) until
  ``n`` pages went back to the free list.  Chains pinned by readers are
  skipped, so eviction can never yank KV out from under a running
  request.  ``on_evict`` (if set) observes each victim chain BEFORE its
  pages are freed — the engine's persistence spill hook.
* In-flight sharing is the same protocol driven by the engine: a live
  slot increfs its full pages below the committed frontier and
  ``insert``s them; duplicates (its own earlier publication) come back
  and are freed, so the cache still ends up holding exactly one
  reference per page while the writer keeps decoding ABOVE the
  published frontier.

Keys are ``np.int64`` sequences: plain token ids for text-only
families, with a per-request ``namespace`` (a digest of the non-token
inputs — VLM image embeds, enc-dec audio) separating subtrees whose KV
depends on more than the token ids.

Persistence
-----------
``dump_chains`` enumerates the refcount-free (cache-only) root-to-leaf
chains hot-first; ``save_store``/``load_store`` serialize them — token
keys plus the per-layer page bytes the engine gathers/scatters — to a
host-side ``.npz`` with a metadata header (config digest, params
fingerprint, page geometry, each pool leaf's shape and torch dtype
name).  numpy has no bfloat16, so a bfloat16 leaf's pages travel as
their int16 bit pattern (``host_dtype``) and come back bit-identical.
``load_store`` REFUSES a corrupt or mismatched store with
``PrefixStoreError`` so a restarted hub falls back to a cold start
instead of serving another model's KV.
"""
from __future__ import annotations

import itertools
import json
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.kv_pool import KVBlockPool, blocks_for_tokens

PERSIST_VERSION = 1


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype a pool leaf of torch dtype ``name`` is stored as
    on the host: its own, but int16 (the same bits) for bfloat16."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


class PrefixStoreError(ValueError):
    """A persisted prefix store is corrupt or belongs to a different
    engine configuration — callers must fall back to a cold start."""


class _Node:
    """One radix edge: ``key`` (any token length; a non-page-multiple
    length makes this a childless partial-tail leaf) and the page chain
    holding its KV; children keyed by their first token."""

    __slots__ = ("key", "blocks", "children", "parent", "stamp")

    def __init__(self, key: np.ndarray, blocks: list[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.blocks = blocks
        self.children: dict[int, _Node] = {}
        self.parent = parent
        self.stamp = 0


def _common_tokens(edge_key: np.ndarray, key: np.ndarray, pos: int) -> int:
    """Token-granular common prefix of ``edge_key`` and ``key[pos:]``."""
    lim = min(len(edge_key), len(key) - pos)
    if lim <= 0:
        return 0
    neq = np.nonzero(edge_key[:lim] != key[pos:pos + lim])[0]
    return int(neq[0]) if neq.size else lim


class RadixPrefixCache:
    """Token-granularity radix index of (possibly in-flight) chains in
    ``pool``.

    ``on_evict(namespace, full_key, n_leaf_tokens, full_blocks)`` — if
    set — observes every evicted leaf chain before its pages return to
    the pool: ``full_key``/``full_blocks`` cover the whole root-to-leaf
    path (only the leaf's own pages are actually freed; ancestors stay
    indexed), ``n_leaf_tokens`` is the evicted edge's token count.
    """

    def __init__(self, pool: KVBlockPool, block_size: Optional[int] = None,
                 on_evict: Optional[Callable] = None,
                 min_match_tokens: int = 1):
        self.pool = pool
        self.block_size = int(block_size or pool.block_size)
        self.on_evict = on_evict
        # admission floor: a match shorter than this many tokens is
        # reported as a MISS (a 1-token accidental hit makes the caller
        # CoW-fork a page for near-zero reuse).  1 accepts any hit.
        self.min_match_tokens = max(1, int(min_match_tokens))
        self.short_matches = 0        # matches rejected by the floor
        # roots per namespace: extras-digest -> top-level node
        self._roots: dict[int, _Node] = {}
        self._clock = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.hit_blocks = 0
        self.hit_tokens = 0
        # counterfactual: what a block-granular matcher would
        # have returned for the same queries — the benchmark's proof
        # that token-granular matching strictly increases reuse
        self.hit_tokens_block = 0
        self.evicted_blocks = 0
        self.inserted_blocks = 0
        self.replaced_blocks = 0      # partial tails superseded by longer chains
        # hit-length histogram, live only after attach_metrics (telemetry)
        self._m_hit_hist = None

    # ------------------------------------------------------------------
    def _root(self, namespace: int) -> _Node:
        if namespace not in self._roots:
            self._roots[namespace] = _Node(np.zeros((0,), np.int64), [], None)
        return self._roots[namespace]

    def _match_walk(self, namespace: int, key: np.ndarray):
        """Longest token-granular match: returns (nodes touched, blocks,
        matched token count).  Pure walk — no refcounts, no stamps."""
        bs = self.block_size
        node = self._roots.get(namespace)
        if node is None:
            return [], [], 0
        nodes, blocks, matched = [node], [], 0
        pos = 0
        while pos < len(key):
            child = node.children.get(int(key[pos]))
            if child is None:
                break
            c = _common_tokens(child.key, key, pos)
            if c == 0:
                break
            nodes.append(child)
            blocks.extend(child.blocks[:blocks_for_tokens(c, bs)])
            matched += c
            pos += c
            if c < len(child.key):
                break                      # stopped mid-edge
            node = child
        return nodes, blocks, matched

    # ------------------------------------------------------------------
    def match(self, key, namespace: int = 0,
              max_tokens: Optional[int] = None):
        """Longest shared prefix of ``key`` already in the cache, at
        TOKEN granularity.

        Returns ``(blocks, n_tokens)``: ``blocks`` covers
        ``ceil(n_tokens / block_size)`` pages; when ``n_tokens`` is not
        a page multiple the LAST page is only partially matched — the
        caller must CoW-fork it before writing its suffix (positions
        ``>= n_tokens`` of that page hold another chain's KV and are
        only masked, not absent).  ``n_tokens`` is capped at
        ``max_tokens`` (callers cap at ``len(prompt) - 1`` so at least
        one suffix token remains to produce admission logits).  Every
        returned page is incref'd FOR THE CALLER, and the touched nodes
        are LRU-stamped.
        """
        key = np.asarray(key, np.int64)
        bs = self.block_size
        nodes, blocks, matched = self._match_walk(namespace, key)
        raw = matched
        if max_tokens is not None and matched > max_tokens:
            matched = max_tokens
        blocks = blocks[:blocks_for_tokens(matched, bs)]
        if 0 < matched < self.min_match_tokens:
            # below the admission floor: no refcounts taken, no LRU
            # stamp — the caller proceeds exactly as on a cold miss
            self.short_matches += 1
            matched = 0
        if matched == 0:
            self.misses += 1
            return [], 0
        stamp = next(self._clock)
        for nd in nodes:
            nd.stamp = stamp
        self.pool.share(blocks)
        self.hits += 1
        self.hit_blocks += len(blocks)
        self.hit_tokens += matched
        if self._m_hit_hist is not None:
            self._m_hit_hist.observe(matched)
        bg_cap = (raw if max_tokens is None
                  else (max_tokens // bs) * bs)
        self.hit_tokens_block += min((raw // bs) * bs, bg_cap)
        return list(blocks), matched

    def unrecord_hit(self, n_blocks: int, n_tokens: int = 0,
                     n_tokens_block: int = 0) -> None:
        """Roll back one recorded hit whose chain the reader released
        WITHOUT using it (e.g. admission skipped the request this
        round and will re-match later) — keeps ``hits``/``hit_*``
        meaning "admissions actually served from the cache" instead of
        counting every retry of the same queued request."""
        self.hits -= 1
        self.hit_blocks -= n_blocks
        self.hit_tokens -= n_tokens
        self.hit_tokens_block -= n_tokens_block

    # ------------------------------------------------------------------
    def _split(self, node: _Node, at: int) -> None:
        """Split ``node``'s edge after ``at`` tokens (page multiple):
        node keeps the head, a new child gets the tail + old children."""
        bs = self.block_size
        assert at % bs == 0, "edges split on page boundaries only"
        tail = _Node(node.key[at:], node.blocks[at // bs:], node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.stamp = node.stamp
        node.key = node.key[:at]
        node.blocks = node.blocks[:at // bs]
        node.children = {int(tail.key[0]): tail}

    def insert(self, key, blocks: list[int], namespace: int = 0) -> list[int]:
        """Index ``blocks`` (pages covering ``key``, the last one
        possibly partial) under the tree, adopting the caller's pool
        references for pages that extend it.  Returns the caller's ids
        made redundant by an existing indexed prefix — the caller must
        free those.  ``len(blocks)`` must equal
        ``blocks_for_tokens(len(key))``.

        Adoption rules (the oracle the property suite checks): with
        ``m`` = the longest token prefix of ``key`` already indexed,
        the tail past ``m`` is adopted iff ``m`` lands on a page
        boundary (new child / edge split) or exactly at the end of a
        resident partial-tail leaf (the leaf's partial page is released
        and the longer chain replaces it).  A divergence in the middle
        of a resident page keeps the resident chain and refuses the
        incoming tail — two chains cannot share a physical page they
        disagree on.
        """
        key = np.asarray(key, np.int64)
        bs = self.block_size
        if len(blocks) != blocks_for_tokens(len(key), bs):
            raise ValueError(
                f"insert: key of {len(key)} tokens vs {len(blocks)} "
                f"blocks of {bs}")
        if not blocks:
            return []
        node = self._root(namespace)
        pos = 0                                  # always page-aligned here
        stamp = next(self._clock)
        node.stamp = stamp
        while pos < len(key):
            child = node.children.get(int(key[pos]))
            if child is None:
                new = _Node(key[pos:], list(blocks[pos // bs:]), node)
                new.stamp = stamp
                node.children[int(key[pos])] = new
                self.inserted_blocks += len(new.blocks)
                return list(blocks[:pos // bs])     # duplicates of prefix
            c = _common_tokens(child.key, key, pos)
            child.stamp = stamp
            rem = len(key) - pos
            if c == len(child.key):
                if len(child.key) % bs == 0:
                    pos += c
                    node = child
                    continue                      # full aligned edge: descend
                # resident partial-tail leaf fully matched
                if c == rem:
                    return list(blocks)           # incoming ends with it
                # incoming EXTENDS the partial tail: replace the
                # superseded partial page with the longer chain's pages
                fb = len(child.key) // bs
                old_tail = child.blocks[fb:]
                child.key = key[pos:]
                child.blocks = (child.blocks[:fb]
                                + list(blocks[pos // bs + fb:]))
                self.pool.free(old_tail)          # cache's own reference
                self.replaced_blocks += len(old_tail)
                self.inserted_blocks += len(blocks) - (pos // bs + fb)
                return list(blocks[:pos // bs + fb])
            # c < len(child.key): incoming ran out or diverged mid-edge
            if c == rem:
                return list(blocks)               # prefix of resident: dup
            cb = (c // bs) * bs
            if c % bs != 0 or cb == 0:
                # divergence inside a page: the resident chain keeps the
                # page; the incoming tail cannot be keyed apart
                return list(blocks)
            self._split(child, cb)
            new = _Node(key[pos + cb:], list(blocks[(pos + cb) // bs:]),
                        child)
            new.stamp = stamp
            child.children[int(key[pos + cb])] = new
            self.inserted_blocks += len(new.blocks)
            return list(blocks[:(pos + cb) // bs])
        return list(blocks)                          # fully duplicate

    # ------------------------------------------------------------------
    def _evictable(self, node: _Node) -> bool:
        """A subtree is evictable iff every page in it has pool
        refcount 1 (the cache's own reference) — no active reader."""
        return all(self.pool.refcount(b) == 1 for b in node.blocks) and \
            all(self._evictable(c) for c in node.children.values())

    def evictable_blocks(self) -> int:
        """Pages the cache could return to the pool RIGHT NOW (maximal
        evictable subtrees) — admission counts these as available."""
        def count(node: _Node) -> int:
            if self._evictable(node):
                return self._size(node)
            return sum(count(c) for c in node.children.values())
        return sum(count(r) for r in self._roots.values())

    @staticmethod
    def _size(node: _Node) -> int:
        return len(node.blocks) + sum(RadixPrefixCache._size(c)
                                      for c in node.children.values())

    def _leaves(self) -> list[tuple[int, "_Node"]]:
        out = []

        def walk(ns, node):
            if not node.children and node.parent is not None:
                out.append((ns, node))
            for c in node.children.values():
                walk(ns, c)
        for ns, r in self._roots.items():
            walk(ns, r)
        return out

    @staticmethod
    def _full_path(node: _Node) -> tuple[np.ndarray, list[int]]:
        """(full key, full block chain) for the root-to-``node`` path."""
        keys, blocks, nd = [], [], node
        while nd is not None and nd.parent is not None:
            keys.append(nd.key)
            blocks = list(nd.blocks) + blocks
            nd = nd.parent
        key = (np.concatenate(keys[::-1]) if keys
               else np.zeros((0,), np.int64))
        return key, blocks

    def evict(self, n_blocks: int) -> int:
        """Free LRU leaf chains (cache-only pages) until ``n_blocks``
        pages returned to the pool or nothing more is evictable.
        Returns the number of pages actually freed."""
        freed = 0
        while freed < n_blocks:
            leaves = [(ns, lf) for ns, lf in self._leaves()
                      if all(self.pool.refcount(b) == 1
                             for b in lf.blocks)]
            if not leaves:
                break
            ns, victim = min(leaves, key=lambda t: t[1].stamp)
            if self.on_evict is not None:
                full_key, full_blocks = self._full_path(victim)
                self.on_evict(ns, full_key, len(victim.key), full_blocks)
            self.pool.free(victim.blocks)
            freed += len(victim.blocks)
            self.evicted_blocks += len(victim.blocks)
            parent = victim.parent
            del parent.children[int(victim.key[0])]
        return freed

    # ------------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        """Pages currently indexed (cache holds one ref each)."""
        return sum(self._size(r) for r in self._roots.values())

    def attach_metrics(self, registry) -> list:
        """Register one ``prefix_cache.<key>`` callback gauge per
        ``stats()`` field into a ``serving.telemetry.MetricsRegistry``
        plus a ``prefix_cache.hit_tokens_hist`` histogram (tokens per
        served hit, observed by ``match``; ``unrecord_hit`` cannot roll
        a histogram sample back, so the histogram counts *recorded*
        hits, the gauges count *served* ones).  Returns the stats keys
        in dict order so callers can build compatibility views."""
        keys = list(self.stats().keys())
        for k in keys:
            registry.gauge(f"prefix_cache.{k}",
                           (lambda k=k: self.stats()[k]))
        self._m_hit_hist = registry.histogram(
            "prefix_cache.hit_tokens_hist",
            (16, 32, 64, 128, 256, 512, 1024))
        return keys

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "hit_blocks": self.hit_blocks,
            "hit_tokens": self.hit_tokens,
            "hit_tokens_block": self.hit_tokens_block,
            "cached_blocks": self.num_blocks,
            "evicted_blocks": self.evicted_blocks,
            "inserted_blocks": self.inserted_blocks,
            "replaced_blocks": self.replaced_blocks,
            "short_matches": self.short_matches,
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"RadixPrefixCache(blocks={self.num_blocks}, "
                f"hits={self.hits}, misses={self.misses})")


# ---------------------------------------------------------------------------
# persistence: hot chains across engine restarts
# ---------------------------------------------------------------------------

def dump_chains(cache: RadixPrefixCache, max_blocks: Optional[int] = None):
    """Enumerate refcount-free chains for persistence, hot-first.

    Returns ``[(namespace, full_key, full_blocks), ...]`` — one entry
    per leaf, covering the whole root-to-leaf path, truncated at the
    first node whose pages a reader still pins.  Pins are root-anchored
    (match/publish/preempt all hold root-to-k prefixes), so a chain
    with ANY pinned page is in practice skipped whole — "refcount-free
    chains" only; call this after drain (``engine.close()`` at
    shutdown) to persist everything.  ``max_blocks`` caps the total
    page budget (hot chains win; a chain that does not fit whole is
    skipped, shared-prefix pages are counted once).

    Known flat-store limitation (a tree-structured store would lift
    it): the BUDGET dedups shared-prefix pages but the serialized
    chains each carry their full root-to-leaf page bytes, so sibling
    chains duplicate their common prefix on disk, and rehydration
    transiently allocates a chain's full length before ``insert``
    hands the duplicate prefix pages back — a pool sized exactly to
    the deduped footprint can skip late chains that would have fit."""
    out, seen_pages, seen_keys = [], set(), set()
    budget = max_blocks if max_blocks is not None else float("inf")
    leaves = sorted(cache._leaves(), key=lambda t: -t[1].stamp)
    for ns, leaf in leaves:
        # path root->leaf, truncated at the first pinned node
        path, nd = [], leaf
        while nd is not None and nd.parent is not None:
            path.append(nd)
            nd = nd.parent
        path = path[::-1]
        keys, blocks = [], []
        for nd in path:
            if any(cache.pool.refcount(b) != 1 for b in nd.blocks):
                break
            keys.append(nd.key)
            blocks.extend(nd.blocks)
        if not blocks:
            continue
        full_key = np.concatenate(keys)
        ident = (ns, full_key.tobytes())
        if ident in seen_keys:
            continue     # two pinned siblings truncated to one ancestor
        fresh = [b for b in blocks if b not in seen_pages]
        if len(fresh) > budget:
            continue
        budget -= len(fresh)
        seen_pages.update(fresh)
        seen_keys.add(ident)
        out.append((ns, full_key, blocks))
    return out


def save_store(path: str, meta: dict, chains) -> dict:
    """Write a prefix store: ``chains`` is
    ``[(namespace, key, pages_per_leaf), ...]`` where ``pages_per_leaf``
    is one ``(stack..., n_chain_blocks, block, kv...)`` host array per
    pool leaf (block axis 1, engine layout; ``host_dtype`` of the
    leaf's dtype).  Returns a summary dict."""
    arrays = {
        "meta": np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), np.uint8).copy(),
        "n_chains": np.asarray(len(chains), np.int64),
    }
    n_blocks = 0
    for i, (ns, key, pages) in enumerate(chains):
        arrays[f"ns_{i}"] = np.asarray(ns, np.int64)
        arrays[f"key_{i}"] = np.asarray(key, np.int64)
        for j, pg in enumerate(pages):
            arrays[f"pages_{i}_{j}"] = pg
        n_blocks += pages[0].shape[1] if pages else 0
    # write through a file object: np.savez_compressed appends ".npz"
    # to a bare string path, which would silently break the save/load
    # round-trip for any persist path without that suffix
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return {"chains": len(chains), "blocks": n_blocks}


def load_store(path: str, expect_meta: dict):
    """Read a prefix store written by ``save_store`` and validate its
    header against ``expect_meta`` (engine geometry + config/params
    digests).  Returns ``[(namespace, key, pages_per_leaf), ...]``.
    Raises :class:`PrefixStoreError` on any corruption or mismatch —
    the caller starts cold instead of crashing (or worse, serving
    stale KV from a different model)."""
    # normalize through JSON so tuple/list representation differences
    # between the in-memory meta and the round-tripped one never count
    # as a mismatch
    expect_meta = json.loads(json.dumps(expect_meta, sort_keys=True))
    try:
        with np.load(path) as data:
            meta = json.loads(bytes(data["meta"]).decode())
            if meta != expect_meta:
                drift = sorted(k for k in set(meta) | set(expect_meta)
                               if meta.get(k) != expect_meta.get(k))
                raise PrefixStoreError(
                    f"prefix store {path} belongs to a different engine "
                    f"configuration (mismatched: {drift})")
            chains = []
            for i in range(int(data["n_chains"])):
                key = np.asarray(data[f"key_{i}"], np.int64)
                nb = blocks_for_tokens(len(key), expect_meta["block_size"])
                pages = []
                for j, sig in enumerate(expect_meta["leaves"]):
                    shape, dtype = sig
                    pg = data[f"pages_{i}_{j}"]
                    want_dt = host_dtype(dtype)
                    want = (tuple(shape[:1]) + (nb,) + tuple(shape[1:]))
                    if tuple(pg.shape) != want or pg.dtype != want_dt:
                        raise PrefixStoreError(
                            f"prefix store {path}: chain {i} page tensor "
                            f"{tuple(pg.shape)}/{pg.dtype} != expected "
                            f"{want}/{dtype}")
                    pages.append(pg)
                chains.append((int(data[f"ns_{i}"]), key, pages))
            return chains
    except PrefixStoreError:
        raise
    except Exception as e:                       # corrupt zip/json/keys
        raise PrefixStoreError(
            f"prefix store {path} is unreadable: {e!r}") from e
