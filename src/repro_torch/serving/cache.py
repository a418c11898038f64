"""KV arenas (port of `repro.serving.cache`: `make_arena`, `SlotArena`
and `PagedArena` with its prefix cache, either kv-sharded over a
serving mesh).

Both keep the engine's protocol: slot leases and their page budget
(`can_admit`, `alloc`, `release`, `pages_needed`, `committed_for`,
`budget_left`), on-demand growth (`touch`, `touch_range`), the dispatch
view (`decode_view`), a finished B=1 prefill scattered into a slot
(`write_slot`), and the telemetry surface (`reject_reason`,
`span_pages`, `gauges`, `stats`, `reset_peaks`).  The prefix cache's
methods are the paged arena's alone: the cache needs it.

`SlotArena` (the reference's default, `ServingConfig.paged` False):
`n_slots` rows of `max_len` positions allocated once; a slot is leased
whole and its stale contents stay masked until the next tenant writes
over them.  Its storage is the paged layout with one page a slot:
pools (n_layers, n_slots + 1, K, max_len, hd), slot s on page s + 1 by
the fixed table (n_slots, 1), page 0 the trash page that parked rows
write (`models.lm.DecoderLM.init_caches`).  So the attention and the
paged kernel serve it unchanged, and its rows hold the bytes the
reference's (B, K, T, hd) cache does.

The recurrent families (`DecoderLM.recurrent`: ssm, hybrid) keep every
slot's recurrent state in both arenas, {"conv", "h"} of n_slots rows
(`DecoderLM.init_state`), which the whole-prompt prefill writes
(`write_slot`) and every dispatch advances in place; the ssm family has
no KV pools, the hybrid has both (`DecoderLM.has_kv`), its shared
attention's pools paged or contiguous like a dense model's.  A
released slot keeps its stale state, as the reference's rows do, until
the next admission's prefill overwrites it.  The paged arena leases,
commits and materializes pages for an ssm model exactly as the
reference's does (its cache leaves have no sequence axis, so no page
holds data), so its page table and budget step as the reference's.

PagedArena:
At kv_bits 4 the pools are int4-packed: each K/V leaf's trailing
head_dim axis is halved (two nibbles per int8 cell, both of one
position), so the page and table arithmetic is the int8 arena's.

A pool of `n_pages` pages of `page_size` positions, plus page 0, the
PAGE_NULL trash page.  Admission leases a slot (decode row) and
COMMITS the request's own worst-case page budget, so an on-demand
allocation mid-decode can never fail; physical pages are allocated
lazily (`touch` / `touch_range`) as the request writes and recycled
wholesale on `release`.

`prefix_cache=True` adds refcounted page sharing: a trie keyed by the
bytes of each full page's tokens, chained from the root, maps token
prefixes to physical pages.  Admission installs the longest registered
match into the new slot's table row and charges only the unshared
suffix; `touch` copies a shared or registered page into a private one
before the first write into it (copy-on-write); pages whose last
reference drops stay WARM (registered, refcount 0) under the
`keep_pages` budget and are evicted LRU when a pop needs them.  The
invariant `committed_pages + pinned_cache_pages <= n_pages` keeps every
future pop covered by free plus warm pages.

Host bookkeeping (free lists, page table, lengths, commitments,
refcounts, the trie) is numpy and Python, as in the reference.  The
pools are torch tensors on the serving device, laid out per
`models.lm.DecoderLM.init_pools`, and the dispatch writes them in
place; `decode_view()` hands them out with the page table copied to
the device.  The copy-on-write page copy is torch indexing on both
pools, enqueued on the device before the dispatch that follows it.

Kv-head sharding (`ServingConfig.kv_shard` over `mesh`, the
counterpart of the reference's `_arena_place`): each rank's pools hold
its contiguous range of the kv heads (`kv_range`,
`sharding.rules.kv_head_range`), (.., K/n, positions, hd) for a
"model" width n that divides K (int4-packed pools alike), where
`sharding.rules.arena_leaf_spec` puts the KV leaves' kv-head axis; a
width that does not divide K keeps every head on every rank.  The recurrent state
and the page table stay whole on every rank, and so does the host
bookkeeping: page allocation, the prefix trie and copy-on-write run
the same on every rank over its own pools (a page holds all kv heads
of its positions).  `stats()` reports the rank's `pool_bytes`, and a
sharded arena also `pool_bytes_total` (every rank's) and `kv_heads`
(the rank's), which its `gauges()` carry too.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.layers.attention import PAGE_NULL
from repro_torch.sharding.rules import kv_head_range


def make_arena(lm, cfg):
    """The arena a `ServingConfig` describes (the one construction site
    of both), its pools kv-sharded where the config says so
    (`sharding.rules.kv_head_range`)."""
    kv_range = (kv_head_range(lm.cfg.n_kv_heads, cfg.mesh)
                if cfg.kv_shard and lm.has_kv else None)
    if cfg.paged:
        return PagedArena(
            lm, cfg.n_slots, cfg.max_len, cfg.page_size, cfg.n_pages,
            device=cfg.device, kv_bits=cfg.kv_bits,
            prefix_cache=cfg.prefix_cache, keep_pages=cfg.cache_keep_pages,
            kv_range=kv_range)
    return SlotArena(lm, cfg.n_slots, cfg.max_len, device=cfg.device,
                     kv_range=kv_range)


def _kv_split(arena, lm, kv_range: Optional[slice]):
    """An arena's kv-head range, the count it holds (None: all) and the
    number of ranks that split the heads."""
    arena.kv_range = kv_range
    arena.kv_heads = (None if kv_range is None
                      else kv_range.stop - kv_range.start)
    arena.kv_split = (1 if kv_range is None
                      else lm.cfg.n_kv_heads // arena.kv_heads)


def _pool_stats(arena) -> dict:
    """The rank's pool bytes (the K/V pools and the recurrent state),
    and on a kv-sharded arena every rank's and the rank's kv heads."""
    kv = sum(arena.caches[k].numel() * arena.caches[k].element_size()
             for k in ("k", "v") if k in arena.caches)
    other = sum(arena.caches[k].numel() * arena.caches[k].element_size()
                for k in ("conv", "h") if k in arena.caches)
    out = {"pool_bytes": kv + other}
    if arena.kv_split > 1:
        out["pool_bytes_total"] = kv * arena.kv_split + other
        out["kv_heads"] = int(arena.caches["k"].shape[2])
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`.  On the card the copy is
    non-blocking from pinned memory, so enqueueing it never waits for
    the device; on the CPU it is the array itself."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def float_cache_leaves(caches) -> List[Tuple[str, torch.dtype]]:
    """(path, dtype) of every floating-point tensor in a cache tree of
    dicts, lists and tuples, paths spelled as the reference's
    (``['k']``, ``[0]``).

    The integer-only serving invariant: an ID run keeps its KV caches
    as int8 images (and int32 page tables).  The one sanctioned
    exception is the SSM recurrent ``h`` state, the scan's float
    island (`layers.ssm`)."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor) and x.is_floating_point():
            out.append((path, x.dtype))

    walk(caches, "")
    return out


def assert_integer_caches(caches, *, allow_ssm_state: bool = False):
    """Raise if an ID cache tree holds a float leaf (see
    `float_cache_leaves`); `allow_ssm_state` lets ``'h'`` leaves
    pass."""
    bad = float_cache_leaves(caches)
    if allow_ssm_state:
        bad = [(p, d) for p, d in bad if "'h'" not in p]
    if bad:
        raise AssertionError(
            "float leaves in ID serving caches (integer-only invariant "
            f"violated): {bad}")


class SlotArena:
    """Slot rows of `max_len` positions, leased whole (free -> leased ->
    free); see the module docstring for the storage."""

    def __init__(self, lm, n_slots: int, max_len: int, *, device="cuda",
                 kv_range: Optional[slice] = None):
        if max_len > lm.max_seq:
            raise ValueError(
                f"max_len {max_len} exceeds model max_seq {lm.max_seq}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.recurrent, self.has_kv = lm.recurrent, lm.has_kv
        _kv_split(self, lm, kv_range)
        self.caches = lm.init_caches(n_slots, max_len, device=self.device,
                                     kv_heads=self.kv_heads)
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0
        self.lengths = np.zeros(n_slots, np.int32)  # written positions
        self.owner: List[Optional[int]] = [None] * n_slots

    # -- lifecycle ------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_leased(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def budget_left(self) -> Optional[int]:
        """No page dimension: slots are the only admission gate."""
        return None

    def can_admit(self, prompt_len: int, total_len: int,
                  tokens=None) -> bool:
        """A free slot holds any request the scheduler lets in."""
        return bool(self._free)

    def check_request(self, prompt_len: int, total_len: int):
        """Slot capacity is length-gated by the scheduler; no-op."""

    def pages_needed(self, total_len: int) -> int:
        return 0

    def committed_for(self, slot: int) -> int:
        return 0

    def alloc(self, req_id: int, prompt_len: int,
              total_len: Optional[int] = None, written: Optional[int] = None,
              tokens=None) -> int:
        """Lease a free slot; `written` positions are materialized at
        admission (None: the whole prompt, the one-shot prefill; 0: the
        chunked path's)."""
        if not self._free:
            raise RuntimeError("no free slots")
        slot = self._free.pop()
        self.owner[slot] = req_id
        self.lengths[slot] = prompt_len if written is None else written
        return slot

    def release(self, slot: int):
        """Recycle a slot; its contents stay, masked until overwritten."""
        if self.owner[slot] is None:
            raise RuntimeError(f"slot {slot} is not leased")
        self.owner[slot] = None
        self.lengths[slot] = 0
        self._free.append(slot)

    def touch(self, slot: int, pos: int):
        """Contiguous rows need no on-demand growth; no-op."""

    def touch_range(self, slot: int, start: int, end: int):
        """Contiguous rows need no on-demand growth; no-op."""

    def advance(self, slot: int, n: int = 1):
        self.lengths[slot] += n

    def reset_peaks(self):
        """No high-water marks to reset."""

    # -- device view ----------------------------------------------------
    def to_device(self, a: np.ndarray) -> torch.Tensor:
        return _to_device(a, self.device)

    def write_slot(self, slot: int, single: dict):
        """Copy a B=1 cache (`init_caches(1, max_len)`, a finished
        prefill) into `slot`'s row, every layer at once."""
        if self.recurrent:
            _write_state(self.caches, slot, single)
        if self.has_kv:
            for kv in ("k", "v"):
                self.caches[kv][:, slot + 1] = single[kv][:, 1]

    def decode_view(self) -> dict:
        """The pools and the fixed slot table, already on the device."""
        return self.caches

    # -- telemetry ------------------------------------------------------
    def reject_reason(self, prompt_len: int, total_len: int) -> str:
        return "no_slot"

    def span_pages(self, slot: int, start: int, end: int) -> list:
        """Contiguous rows have no pages."""
        return []

    def gauges(self) -> dict:
        out = {
            "n_leased": self.n_leased,
            "n_free": self.n_free,
            "occupancy": self.n_leased / self.n_slots,
        }
        if self.kv_split > 1:
            out.update(_pool_stats(self))
        return out

    def stats(self) -> dict:
        out = {
            "arena": "slot",
            "arena_positions": self.n_slots * self.max_len,
        }
        if self.kv_split > 1:
            out.update(_pool_stats(self))
        return out


def _write_state(caches: dict, slot: int, single: dict):
    """A finished B=1 prefill's recurrent state into `slot`'s row."""
    for key in ("conv", "h"):
        caches[key][:, slot] = single[key][:, 0]


class _PrefixNode:
    """One registered full page of prefix content (a trie node), keyed
    in its parent's `children` by the raw bytes of the page's int32
    tokens.  Reaching a node at depth d certifies the token prefix
    [0, (d + 1) * page_size) byte for byte, which is exactly what the
    KV image of that page depends on."""

    __slots__ = ("parent", "key", "page", "children")

    def __init__(self, parent, key: bytes, page: int):
        self.parent = parent
        self.key = key
        self.page = page
        self.children: dict = {}


class PagedArena:
    def __init__(self, lm, n_slots: int, max_len: int, page_size: int = 16,
                 n_pages: int = 64, *, device="cuda", kv_bits: int = 8,
                 prefix_cache: bool = False, keep_pages: int = 0,
                 kv_range: Optional[slice] = None):
        if max_len > lm.max_seq:
            raise ValueError(
                f"max_len {max_len} exceeds model max_seq {lm.max_seq}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages_per_slot = -(-max_len // page_size)
        self.kv_bits = kv_bits
        self.device = torch.device(device)
        self.recurrent, self.has_kv = lm.recurrent, lm.has_kv
        _kv_split(self, lm, kv_range)
        self.caches = (lm.init_state(n_slots, device=self.device)
                       if self.recurrent else {})
        if self.has_kv:
            self.caches.update(lm.init_pools(
                n_pages, page_size, device=self.device, kv_bits=kv_bits,
                kv_heads=self.kv_heads))

        # host bookkeeping; pop() -> lowest first
        self._free_slots = list(range(n_slots - 1, -1, -1))
        self._free_pages = list(range(n_pages, 0, -1))
        self.page_table = np.full(
            (n_slots, self.pages_per_slot), PAGE_NULL, np.int32)
        self.lengths = np.zeros(n_slots, np.int32)
        self.owner: List[Optional[int]] = [None] * n_slots
        self._commit = np.zeros(n_slots, np.int32)
        self.committed_pages = 0
        self.max_pages_in_use = 0
        self.max_committed = 0

        # prefix cache: refcounts count table-row references per page
        # (kept with the cache off too); the trie maps full-page token
        # content to pages; _warm holds registered refcount-0 pages in
        # LRU (insertion) order
        self.prefix_cache = bool(prefix_cache)
        self.keep_pages = int(keep_pages)
        self.refcount = np.zeros(n_pages + 1, np.int32)
        self._trie_root = _PrefixNode(None, b"", PAGE_NULL)
        self._page_node: dict = {}  # physical page -> _PrefixNode
        self._warm: dict = {}  # page -> None, LRU by insertion
        self._slot_node: List[_PrefixNode] = [self._trie_root] * n_slots
        self._slot_registered = np.zeros(n_slots, np.int32)
        self.shared_at_admit = np.zeros(n_slots, np.int32)
        self.on_cow = None  # engine hook: fn(slot, old_page, new_page)
        self.prefix_hits = 0  # admissions that matched >= 1 page
        self.prefix_misses = 0  # cache-eligible admissions, no match
        self.prefix_hit_pages = 0  # pages served without recompute
        self.cow_splits = 0
        self.warm_evictions = 0

    # -- page accounting ------------------------------------------------
    def _pages_for(self, total_len: int) -> int:
        """Worst-case pages for a request writing [0, total_len - 1)."""
        return -(-max(total_len - 1, 1) // self.page_size)

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_leased(self) -> int:
        return self.n_slots - len(self._free_slots)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free_pages)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def cache_pages(self) -> int:
        """Pages the prefix cache owns (registered in the trie)."""
        return len(self._page_node)

    @property
    def warm_pages(self) -> int:
        """Registered pages no slot references, evictable on demand."""
        return len(self._warm)

    @property
    def pinned_cache_pages(self) -> int:
        """Registered pages some slot still references."""
        return len(self._page_node) - len(self._warm)

    @property
    def budget_left(self) -> int:
        """Uncommitted pages: warm pages count as available, pinned
        cache pages do not."""
        return self.n_pages - self.committed_pages - self.pinned_cache_pages

    def pages_needed(self, total_len: int) -> int:
        return self._pages_for(total_len)

    def _match_node(self, tokens) -> Tuple[List[int], _PrefixNode]:
        """The physical pages of the longest registered full-page prefix
        of `tokens`, and the deepest node matched."""
        toks = np.asarray(tokens, np.int32)
        node = self._trie_root
        pages: List[int] = []
        ps = self.page_size
        for blk in range(toks.size // ps):
            child = node.children.get(toks[blk * ps:(blk + 1) * ps].tobytes())
            if child is None:
                break
            pages.append(child.page)
            node = child
        return pages, node

    def _discount(self, matched: int, prompt_len: int) -> int:
        """Commit discount for `matched` shared pages of a
        `prompt_len`-token source.  When the match covers the whole
        source, its last position is still recomputed (its logits seed
        decode) inside the last shared page, which copy-on-writes into a
        private page: that one stays in the request's own budget."""
        if matched == 0:
            return 0
        if matched * self.page_size < prompt_len:
            return matched
        return matched - 1

    def admit_cost(self, total_len: int, tokens=None) -> int:
        """Pages a request must bring of its own: the worst case minus
        the shared-prefix discount."""
        need = self._pages_for(total_len)
        if tokens is None or not self.prefix_cache:
            return need
        matched, _ = self._match_node(tokens)
        return need - self._discount(len(matched), len(tokens))

    def committed_for(self, slot: int) -> int:
        """Pages committed to `slot`'s lease (returned to the budget if
        a policy preempts it); shrinks as its pages are registered."""
        return int(self._commit[slot])

    def can_admit(self, prompt_len: int, total_len: int,
                  tokens=None) -> bool:
        """A free decode row AND uncommitted budget for the request's
        own worst case.  With `tokens` and the prefix cache on it is
        charged only its unshared suffix, plus the matched pages that
        are warm now (`revive`): installed, they stop being
        evictable."""
        if not self._free_slots:
            return False
        need = self._pages_for(total_len)
        revive = 0
        if self.prefix_cache and tokens is not None:
            matched, _ = self._match_node(tokens)
            need -= self._discount(len(matched), len(tokens))
            revive = sum(1 for p in matched if p in self._warm)
        return (self.committed_pages + self.pinned_cache_pages + revive
                + need <= self.n_pages)

    def check_request(self, prompt_len: int, total_len: int):
        need = self._pages_for(total_len)
        if need > self.n_pages:
            raise ValueError(
                f"request needs {need} pages but the arena holds "
                f"{self.n_pages}")

    def reject_reason(self, prompt_len: int, total_len: int) -> str:
        return "no_slot" if not self._free_slots else "no_pages"

    # -- lifecycle ------------------------------------------------------
    def _pop_page(self) -> int:
        """A free page, evicting the LRU warm page when none is free."""
        if not self._free_pages:
            if not self._warm:
                raise RuntimeError(
                    "page pool exhausted despite commitment accounting")
            self._evict_warm(next(iter(self._warm)))
        return self._free_pages.pop()

    def _evict_warm(self, page: int):
        """Unregister and free one warm page.  Deeper nodes under it
        become unreachable from the root and age out on their own."""
        del self._warm[page]
        node = self._page_node.pop(page)
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        self._free_pages.append(page)
        self.warm_evictions += 1

    def _retire(self, page: int):
        """A registered page's last reference dropped: keep it warm under
        the keep budget (LRU by retirement order)."""
        self._warm[page] = None
        while len(self._warm) > self.keep_pages:
            self._evict_warm(next(iter(self._warm)))

    def alloc(self, req_id: int, prompt_len: int,
              total_len: Optional[int] = None, written: Optional[int] = None,
              tokens=None) -> int:
        """Lease a slot + commit the page budget; allocate pages for the
        positions materialized at admission: the whole prompt for the
        one-shot prefill (`written` None), none on the chunked path
        (`written` 0), whose pages arrive chunk by chunk via
        touch_range.

        `tokens` (prefix cache, `written` 0): the request's source.  The
        longest registered full-page prefix is installed into the slot's
        table row, refcounted and charged to the cache ledger, and
        `lengths[slot]` says how many leading positions admission made
        valid (at most prompt_len - 1: the last source position is
        always recomputed); the engine starts its chunk cursor there."""
        total_len = prompt_len if total_len is None else total_len
        use = (tokens if self.prefix_cache and tokens is not None
               and written == 0 else None)
        if not self.can_admit(prompt_len, total_len, tokens=use):
            raise RuntimeError("out of slots or page budget")
        slot = self._free_slots.pop()
        self.owner[slot] = req_id
        if use is not None:
            shared, node = self._match_node(use)
            need = self._pages_for(total_len) - self._discount(
                len(shared), len(use))
        else:
            shared, node = [], self._trie_root
            need = self._pages_for(total_len)
        self._commit[slot] = need
        self.committed_pages += need
        self.max_committed = max(self.max_committed, self.committed_pages)
        # install the shared prefix; warm pages are revived (pinned)
        for blk, page in enumerate(shared):
            self.page_table[slot, blk] = page
            self.refcount[page] += 1
            self._warm.pop(page, None)
        if self.prefix_cache:
            self._slot_node[slot] = node
            self._slot_registered[slot] = len(shared)
            self.shared_at_admit[slot] = len(shared)
            if use is not None:
                if shared:
                    self.prefix_hits += 1
                    self.prefix_hit_pages += len(shared)
                else:
                    self.prefix_misses += 1
        if shared:
            materialized = min(len(shared) * self.page_size, prompt_len - 1)
        else:
            materialized = prompt_len if written is None else written
        self.lengths[slot] = materialized
        for blk in range(len(shared), -(-materialized // self.page_size)):
            page = self._pop_page()
            self.page_table[slot, blk] = page
            self.refcount[page] = 1
        self.max_pages_in_use = max(self.max_pages_in_use, self.pages_in_use)
        return slot

    def touch(self, slot: int, pos: int):
        """Allocate the page holding `pos` before a write there; a page
        that is shared (refcount > 1) or registered is first split by
        copy-on-write, so a dispatch only ever writes pages its row
        owns alone."""
        blk = pos // self.page_size
        page = int(self.page_table[slot, blk])
        if page != PAGE_NULL:
            if self.prefix_cache and (self.refcount[page] > 1
                                      or page in self._page_node):
                self._cow(slot, blk, page)
            return
        new = self._pop_page()
        self.page_table[slot, blk] = new
        self.refcount[new] = 1
        self.max_pages_in_use = max(self.max_pages_in_use, self.pages_in_use)

    def _copy_page(self, src: int, dst: int):
        """pool[dst] <- pool[src] on both pools, in place."""
        for pool in (self.caches["k"], self.caches["v"]):
            pool[:, dst] = pool[:, src]

    def _cow(self, slot: int, blk: int, old: int):
        """Copy-on-write split of `slot`'s logical block `blk`.  The pop
        is covered by the slot's commit: under the engine the only split
        is the re-prefill of the last position of a page-aligned exact
        match, whose page `_discount` left in the request's budget."""
        new = self._pop_page()
        self._copy_page(old, new)
        self.page_table[slot, blk] = new
        self.refcount[new] = 1
        self.refcount[old] -= 1
        if self.refcount[old] == 0:
            if old in self._page_node:
                self._retire(old)
            else:  # unshared and unregistered: a plain free
                self._free_pages.append(old)
        self.cow_splits += 1
        self.max_pages_in_use = max(self.max_pages_in_use, self.pages_in_use)
        if self.on_cow is not None:
            self.on_cow(slot, old, new)

    def touch_range(self, slot: int, start: int, end: int):
        """Allocate every page covering positions [start, end)."""
        if end <= start:
            return
        for blk in range(start // self.page_size,
                         (end - 1) // self.page_size + 1):
            self.touch(slot, blk * self.page_size)

    def release_pages(self, slot: int) -> List[int]:
        """Drop every page reference of `slot` and point its table row
        back at PAGE_NULL, without ending the lease: pages no other row
        shares are freed, or kept warm if registered.  -> the freed
        page ids."""
        if self.owner[slot] is None:
            raise RuntimeError(f"slot {slot} is not leased")
        freed = []
        for blk in range(self.pages_per_slot):
            page = int(self.page_table[slot, blk])
            if page == PAGE_NULL:
                continue
            self.page_table[slot, blk] = PAGE_NULL
            self.refcount[page] -= 1
            if self.refcount[page] > 0:
                continue  # other rows still share it
            if page in self._page_node:
                self._retire(page)
                continue
            self._free_pages.append(page)
            freed.append(page)
        self.lengths[slot] = 0
        if self.prefix_cache:
            self._slot_node[slot] = self._trie_root
            self._slot_registered[slot] = 0
            self.shared_at_admit[slot] = 0
        return freed

    def release(self, slot: int):
        """Recycle the slot and all its pages; uncommit its budget."""
        self.release_pages(slot)
        self.owner[slot] = None
        self.committed_pages -= int(self._commit[slot])
        self._commit[slot] = 0
        self._free_slots.append(slot)

    def register_prefix(self, slot: int, tokens, upto: int):
        """Publish `slot`'s FULL pages covering positions [0, upto) to
        the prefix cache, moving each newly registered page from the
        slot's commit to the cache ledger.  Idempotent per slot (a block
        cursor); where another slot registered the same content first,
        its pages win and this slot's stay private.  No-op with the
        cache off."""
        if not self.prefix_cache or self.owner[slot] is None:
            return
        nblk = min(int(upto) // self.page_size, self.pages_per_slot)
        cur = int(self._slot_registered[slot])
        if nblk <= cur:
            return
        toks = np.asarray(tokens, np.int32)
        ps = self.page_size
        node = self._slot_node[slot]
        for blk in range(cur, nblk):
            key = toks[blk * ps:(blk + 1) * ps].tobytes()
            child = node.children.get(key)
            if child is None:
                page = int(self.page_table[slot, blk])
                child = _PrefixNode(node, key, page)
                node.children[key] = child
                self._page_node[page] = child
                self._commit[slot] -= 1  # slot-paid -> cache-paid
                self.committed_pages -= 1
            node = child
        self._slot_node[slot] = node
        self._slot_registered[slot] = nblk

    def flush_cache(self) -> int:
        """Evict every warm page now.  -> the number evicted."""
        n = 0
        while self._warm:
            self._evict_warm(next(iter(self._warm)))
            n += 1
        return n

    def advance(self, slot: int, n: int = 1):
        self.lengths[slot] += n

    def reset_peaks(self):
        """Restart the page high-water marks and the prefix counters from
        the current state (`ServingEngine.reset_stats`)."""
        self.max_pages_in_use = self.pages_in_use
        self.max_committed = self.committed_pages
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_pages = 0
        self.cow_splits = 0
        self.warm_evictions = 0

    # -- telemetry ------------------------------------------------------
    def span_pages(self, slot: int, start: int, end: int) -> list:
        """Physical pages backing positions [start, end) of `slot` (the
        `prefill_chunk` event's page context).  Called after
        touch_range, so no PAGE_NULL appears for a real position."""
        if end <= start:
            return []
        ps = self.page_size
        return [int(self.page_table[slot, blk])
                for blk in range(start // ps, (end - 1) // ps + 1)]

    def gauges(self) -> dict:
        """Instantaneous occupancy and page pressure, sampled into each
        telemetry step record (host counters only)."""
        out = {
            "n_leased": self.n_leased,
            "n_free": self.n_free,
            "occupancy": self.n_leased / self.n_slots,
            "pages_in_use": self.pages_in_use,
            "free_pages": self.free_pages,
            "committed_pages": self.committed_pages,
            "max_pages_in_use": self.max_pages_in_use,
        }
        if self.prefix_cache:
            out["cache_pages"] = self.cache_pages
            out["warm_pages"] = self.warm_pages
        if self.kv_split > 1:
            out.update(_pool_stats(self))
        return out

    # -- device view ----------------------------------------------------
    def to_device(self, a: np.ndarray) -> torch.Tensor:
        return _to_device(a, self.device)

    def write_slot(self, slot: int, single: dict):
        """Scatter a B=1 cache (`init_caches(1, max_len)`, a finished
        prefill) through `slot`'s table row: logical block b to page
        table[slot, b].  Blocks with no page land on the trash page, the
        last of them winning, as in the reference's scatter.  The
        recurrent state goes to `slot`'s row."""
        if self.recurrent:
            _write_state(self.caches, slot, single)
        if not self.has_kv:
            return
        ps, pps = self.page_size, self.pages_per_slot
        row = self.page_table[slot]
        real = [b for b in range(pps) if row[b] != PAGE_NULL]
        null = [b for b in range(pps) if row[b] == PAGE_NULL]
        blocks = real + null[-1:]
        pages = self.to_device(np.ascontiguousarray(row[blocks]).astype(
            np.int64))
        idx = self.to_device(np.asarray(blocks, np.int64))
        for kv in ("k", "v"):
            z = single[kv][:, 1]                   # (L, K, max_len, hd)
            L, K, T, hd = z.shape
            if T < pps * ps:
                z = torch.nn.functional.pad(z, (0, 0, 0, pps * ps - T))
            z = z.reshape(L, K, pps, ps, hd).permute(0, 2, 1, 3, 4)
            self.caches[kv][:, pages] = z[:, idx]

    def decode_view(self) -> dict:
        """The pools plus the current page table on the device — the
        paged-attention kernel's layout contract (int8 pools (L,
        n_pages + 1, K, page_size, hd), hd/2 when int4-packed, page 0
        the trash page, an int32
        (n_slots, pages_per_slot) table with PAGE_NULL for unallocated
        blocks), beside the recurrent state where there is one; the ssm
        family's view is its state alone."""
        if not self.has_kv:
            return self.caches
        table = self.to_device(self.page_table.copy())
        return {**self.caches, "table": table}

    def stats(self) -> dict:
        out = {
            "arena": "paged",
            "arena_positions": self.n_pages * self.page_size,
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "kv_bits": self.kv_bits,
            **_pool_stats(self),
            "pages_in_use": self.pages_in_use,
            "committed_pages": self.committed_pages,
            "max_pages_in_use": self.max_pages_in_use,
            "max_committed_pages": self.max_committed,
        }
        if self.prefix_cache:
            out.update({
                "prefix_cache": True,
                "cache_keep_pages": self.keep_pages,
                "cache_pages": self.cache_pages,
                "warm_pages": self.warm_pages,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_pages": self.prefix_hit_pages,
                "cow_splits": self.cow_splits,
                "warm_evictions": self.warm_evictions,
            })
        return out
