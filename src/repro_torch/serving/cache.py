"""Paged KV arena (port of `repro.serving.cache.PagedArena`, without the
prefix cache, warm pages, copy-on-write and sharding).

At kv_bits 4 the pools are int4-packed: each K/V leaf's trailing
head_dim axis is halved (two nibbles per int8 cell, both of one
position), so the page and table arithmetic is the int8 arena's.

A pool of `n_pages` pages of `page_size` positions, plus page 0, the
PAGE_NULL trash page.  Admission leases a slot (decode row) and
COMMITS the request's own worst-case page budget, so an on-demand
allocation mid-decode can never fail; physical pages are allocated
lazily (`touch` / `touch_range`) as the request writes and recycled
wholesale on `release`.

Host bookkeeping (free lists, page table, lengths, commitments) is
numpy and Python, as in the reference.  The pools are torch tensors on
the serving device, laid out per `models.lm.DecoderLM.init_pools`, and
the dispatch writes them in place; `decode_view()` hands them out with
the page table copied to the device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.layers.attention import PAGE_NULL


class PagedArena:
    def __init__(self, lm, n_slots: int, max_len: int, page_size: int = 16,
                 n_pages: int = 64, *, device="cuda", kv_bits: int = 8):
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
        self.caches = lm.init_pools(n_pages, page_size, device=self.device,
                                    kv_bits=kv_bits)

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
    def budget_left(self) -> int:
        return self.n_pages - self.committed_pages

    def pages_needed(self, total_len: int) -> int:
        return self._pages_for(total_len)

    def can_admit(self, prompt_len: int, total_len: int) -> bool:
        """A free decode row AND uncommitted budget for the request's
        own worst case."""
        if not self._free_slots:
            return False
        return (self.committed_pages + self._pages_for(total_len)
                <= self.n_pages)

    def check_request(self, prompt_len: int, total_len: int):
        need = self._pages_for(total_len)
        if need > self.n_pages:
            raise ValueError(
                f"request needs {need} pages but the arena holds "
                f"{self.n_pages}")

    def reject_reason(self, prompt_len: int, total_len: int) -> str:
        return "no_slot" if not self._free_slots else "no_pages"

    # -- lifecycle ------------------------------------------------------
    def alloc(self, req_id: int, prompt_len: int,
              total_len: Optional[int] = None, written: int = 0) -> int:
        """Lease a slot + commit the page budget; allocate pages for the
        `written` positions materialized at admission (0 on the chunked
        path, whose pages arrive chunk by chunk via touch_range)."""
        total_len = prompt_len if total_len is None else total_len
        if not self.can_admit(prompt_len, total_len):
            raise RuntimeError("out of slots or page budget")
        slot = self._free_slots.pop()
        self.owner[slot] = req_id
        need = self._pages_for(total_len)
        self._commit[slot] = need
        self.committed_pages += need
        self.max_committed = max(self.max_committed, self.committed_pages)
        self.lengths[slot] = written
        for blk in range(-(-written // self.page_size)):
            self.page_table[slot, blk] = self._pop_page()
        self.max_pages_in_use = max(self.max_pages_in_use, self.pages_in_use)
        return slot

    def _pop_page(self) -> int:
        if not self._free_pages:
            raise RuntimeError(
                "page pool exhausted despite commitment accounting")
        return self._free_pages.pop()

    def touch(self, slot: int, pos: int):
        """Allocate the page holding `pos` before a write there."""
        blk = pos // self.page_size
        if int(self.page_table[slot, blk]) != PAGE_NULL:
            return
        self.page_table[slot, blk] = self._pop_page()
        self.max_pages_in_use = max(self.max_pages_in_use, self.pages_in_use)

    def touch_range(self, slot: int, start: int, end: int):
        """Allocate every page covering positions [start, end)."""
        if end <= start:
            return
        for blk in range(start // self.page_size,
                         (end - 1) // self.page_size + 1):
            self.touch(slot, blk * self.page_size)

    def release(self, slot: int):
        """Recycle the slot and all its pages; uncommit its budget."""
        if self.owner[slot] is None:
            raise RuntimeError(f"slot {slot} is not leased")
        for blk in range(self.pages_per_slot):
            page = int(self.page_table[slot, blk])
            if page != PAGE_NULL:
                self._free_pages.append(page)
                self.page_table[slot, blk] = PAGE_NULL
        self.lengths[slot] = 0
        self.owner[slot] = None
        self.committed_pages -= int(self._commit[slot])
        self._commit[slot] = 0
        self._free_slots.append(slot)

    def advance(self, slot: int, n: int = 1):
        self.lengths[slot] += n

    def reset_peaks(self):
        """Restart the page high-water marks from the current state
        (`ServingEngine.reset_stats`: a warmup window's peaks must not
        leak into the measured window's report)."""
        self.max_pages_in_use = self.pages_in_use
        self.max_committed = self.committed_pages

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
        return {
            "n_leased": self.n_leased,
            "n_free": self.n_free,
            "occupancy": self.n_leased / self.n_slots,
            "pages_in_use": self.pages_in_use,
            "free_pages": self.free_pages,
            "committed_pages": self.committed_pages,
            "max_pages_in_use": self.max_pages_in_use,
        }

    # -- device view ----------------------------------------------------
    def decode_view(self) -> dict:
        """The pools plus the current page table on the device — the
        paged-attention kernel's layout contract (int8 pools (L,
        n_pages + 1, K, page_size, hd), hd/2 when int4-packed, page 0
        the trash page, an int32
        (n_slots, pages_per_slot) table with PAGE_NULL for unallocated
        blocks)."""
        table = torch.from_numpy(self.page_table.copy()).to(self.device)
        return {"k": self.caches["k"], "v": self.caches["v"], "table": table}

    def stats(self) -> dict:
        return {
            "arena": "paged",
            "arena_positions": self.n_pages * self.page_size,
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "kv_bits": self.kv_bits,
            "pool_bytes": sum(t.numel() * t.element_size()
                              for t in self.caches.values()),
            "pages_in_use": self.pages_in_use,
            "committed_pages": self.committed_pages,
            "max_pages_in_use": self.max_pages_in_use,
            "max_committed_pages": self.max_committed,
        }
