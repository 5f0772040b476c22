"""Paged KV-cache pool (port of ``repro/serve/pool.py``): per-layer page
tensors in the LQ wire format (or fp), plus the host-side page allocator.

Page 0 is reserved as a scratch page: padded page-table entries and
inactive decode slots read and write it, and decode masking keeps its
contents out of every real output.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kvwire, packing
from ..models.config import ModelConfig


def _check_paged_support(cfg: ModelConfig):
    if cfg.family != "dense":
        raise ValueError(f"the port's paged pool serves dense decoders "
                         f"only, got family={cfg.family!r}")


def _check_kv(cfg: ModelConfig, kv_bits, kv_group: int):
    if kv_bits is not None and not isinstance(kv_bits, int):
        raise ValueError("per-layer kv_bits maps (QuantPlan kv sections) are "
                         "not ported yet: ROADMAP.md Queue 1 item 3")
    kvwire.check_kv_bits(kv_bits)
    if kv_bits is not None and cfg.head_dim % kv_group:
        raise ValueError(f"head_dim={cfg.head_dim} not divisible by "
                         f"kv_group={kv_group}")


def make_pool_pages(cfg: ModelConfig, *, n_pages: int, page_size: int,
                    kv_bits=None, kv_group: int = 64, dtype=None,
                    device=None) -> list:
    """Zero-initialized pool pages: one ``{"k", "v"}`` per layer, each leaf
    (n_pages, page_size, KV, D) fp or a wire dict at ``kv_bits``."""
    _check_paged_support(cfg)
    if n_pages < 2:
        raise ValueError("need at least one allocatable page + scratch")
    _check_kv(cfg, kv_bits, kv_group)
    dtype = dtype or cfg.activation_dtype

    def leaf():
        return kvwire.make_paged_kv(n_pages, page_size, cfg.n_kv_heads,
                                    cfg.head_dim, kv_bits, kv_group, dtype,
                                    device)
    return [{"k": leaf(), "v": leaf()} for _ in range(cfg.n_layers)]


def pool_nbytes(cfg: ModelConfig, *, n_pages: int, page_size: int,
                kv_bits=None, kv_group: int = 64, dtype=None) -> int:
    """Resident bytes of a pool with this geometry, without building it;
    equal to the JAX package's count for the same geometry."""
    _check_kv(cfg, kv_bits, kv_group)
    d = cfg.head_dim
    if kv_bits is None:
        itemsize = torch.empty((), dtype=dtype or cfg.activation_dtype) \
            .element_size()
        per_head = d * itemsize
    else:
        per_head = d // packing.codes_per_byte(kv_bits) \
            + 2 * 4 * (d // kv_group)
    return 2 * cfg.n_layers * n_pages * page_size * cfg.n_kv_heads * per_head


class PagedKVPool:
    """Paged KV storage and its host-side page allocator.

    ``n_pages`` counts physical pages including the scratch page 0, so
    ``n_pages - 1`` are allocatable.  A page id spans every layer's tensor,
    so alloc/free/defrag never need the page geometry.
    """

    def __init__(self, cfg: ModelConfig, *, n_pages: int, page_size: int,
                 kv_bits=None, kv_group: int = 64, dtype=None, device=None):
        self.cfg = cfg
        self.n_pages, self.page_size = n_pages, page_size
        self.kv_bits, self.kv_group = kv_bits, kv_group
        self.pages = make_pool_pages(cfg, n_pages=n_pages,
                                     page_size=page_size, kv_bits=kv_bits,
                                     kv_group=kv_group, dtype=dtype,
                                     device=device)
        self._free = list(range(n_pages - 1, 0, -1))   # LIFO free list
        self.page_tables: dict[int, list[int]] = {}    # rid -> ordered pages

    # ---------------------------------------------------------- allocator
    @property
    def n_allocatable(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.n_allocatable - self.n_free

    def occupancy(self) -> float:
        return self.n_allocated / self.n_allocatable

    def alloc(self, rid: int, n: int = 1) -> bool:
        """Append n pages to rid's table; all-or-nothing on exhaustion."""
        if n > len(self._free):
            return False
        got = [self._free.pop() for _ in range(n)]
        self.page_tables.setdefault(rid, []).extend(got)
        return True

    def free(self, rid: int) -> int:
        """Release every page owned by rid; returns how many."""
        pages = self.page_tables.pop(rid, [])
        self._free.extend(reversed(pages))
        return len(pages)

    def pages_of(self, rid: int) -> list[int]:
        return list(self.page_tables.get(rid, []))

    def _leaves(self):
        for layer in self.pages:
            for leaf in layer.values():
                yield from (leaf.values() if kvwire.is_quant_kv(leaf)
                            else (leaf,))

    # ------------------------------------------------------------- rewind
    def truncate(self, rid: int, keep_tokens: int) -> int:
        """Un-write rid's cache past ``keep_tokens`` tokens: those rows go
        back to the all-zero initial state in every layer, and wholly
        unused trailing pages return to the free list.  Returns the number
        of pages released."""
        if keep_tokens < 0:
            raise ValueError(f"keep_tokens must be >= 0, got {keep_tokens}")
        tbl = self.page_tables.get(rid, [])
        keep_pages = -(-keep_tokens // self.page_size)
        if keep_pages > len(tbl):
            raise ValueError(
                f"truncate({rid}, {keep_tokens}) needs {keep_pages} pages "
                f"but the request owns {len(tbl)}")
        for i, page in enumerate(tbl):
            start = max(keep_tokens - i * self.page_size, 0)
            if start < self.page_size:
                for a in self._leaves():
                    a[page, start:] = 0
        drop = tbl[keep_pages:]
        if drop:
            del self.page_tables[rid][keep_pages:]
            self._free.extend(reversed(drop))
        return len(drop)

    def table_array(self, rid: int, max_pages: int) -> np.ndarray:
        """rid's page table as (max_pages,) int32, scratch-padded."""
        tbl = self.page_tables.get(rid, [])
        out = np.zeros((max_pages,), np.int32)
        out[:len(tbl)] = tbl
        return out

    # ------------------------------------------------------------- defrag
    def defrag(self) -> dict[int, int]:
        """Compact allocated pages into [1, n_allocated], keeping each
        request's page order; moves the pages in every layer.  Returns the
        old -> new page mapping."""
        perm = np.empty((self.n_pages,), np.int64)
        perm[0] = 0
        mapping: dict[int, int] = {}
        nxt = 1
        for tbl in self.page_tables.values():
            for old in tbl:
                mapping[old] = nxt
                perm[nxt] = old
                nxt += 1
        perm[nxt:] = [p for p in range(1, self.n_pages) if p not in mapping]
        for a in self._leaves():
            a.copy_(a[torch.as_tensor(perm, device=a.device)])
        self.page_tables = {rid: [mapping[p] for p in tbl]
                            for rid, tbl in self.page_tables.items()}
        self._free = list(range(self.n_pages - 1, nxt - 1, -1))
        return mapping

    # --------------------------------------------------------- accounting
    def nbytes(self) -> int:
        return kvwire.cache_nbytes(self.pages)

    def page_nbytes(self) -> int:
        """Bytes of one page across all layers."""
        return self.nbytes() // self.n_pages
