"""Host-side page accounting for the paged KV cache (a copy of
``areal_tpu/gen/pages.py``; the port imports nothing of the JAX package).

The generation engine's KV memory is a pool of fixed-size pages; slots
hold page tables instead of dense slabs, and prompts SHARE pages for
their longest common page-aligned prefix through a radix tree (one
prefill serves a whole GRPO group). Pure host bookkeeping (free list,
refcounts, prefix registry), byte-agnostic: a page index addresses raw
pages or int8 pages plus their scales alike.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class OutOfPagesError(RuntimeError):
    pass


class PagePool:
    """Fixed pool of KV pages with refcounting (shared prompt pages)."""

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._ref = np.zeros(n_pages, np.int32)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """n fresh pages (refcount 1 each); raises OutOfPagesError."""
        if n > len(self._free):
            raise OutOfPagesError(
                f"need {n} pages, {len(self._free)} free of {self.n_pages}"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._ref[pages] = 1
        return pages

    def ref(self, pages: Sequence[int]):
        """Share existing pages (+1 each)."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"page {p} is free; cannot share")
            self._ref[p] += 1

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def release(self, pages: Sequence[int]):
        """Drop one reference per page; refcount 0 returns it to the pool."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)


@dataclasses.dataclass
class _RadixNode:
    page: int                                   # resident page (one ref held)
    children: Dict[Tuple[int, ...], "_RadixNode"]
    last_used: int                              # LRU tick


class PrefixRegistry:
    """Page-granular radix tree: prompt prefixes -> resident KV pages.

    The counterpart of SGLang's radix cache: each tree level is one page of
    prompt tokens (the child key is that page's token tuple), so any two
    prompts share pages for their longest common PAGE-ALIGNED prefix — a
    GRPO group shares the whole prompt, different questions over one system
    preamble share the preamble pages. The tree holds one refcount per
    resident page; lookups take another for the borrowing slot. Weight
    updates invalidate everything (KV from old params must not serve
    new-policy generations).
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._children: Dict[Tuple[int, ...], _RadixNode] = {}
        self._tick = 0
        self._n_nodes = 0

    def __len__(self) -> int:
        return self._n_nodes  # resident pages held by the tree

    def _chunks(self, prompt_ids: Sequence[int], n_pages: int):
        ps = self.pool.page_size
        return [
            tuple(prompt_ids[i * ps : (i + 1) * ps]) for i in range(n_pages)
        ]

    def lookup(
        self, prompt_ids: Sequence[int], n_full_pages: int
    ) -> Optional[List[int]]:
        """Pages covering the LONGEST cached page-aligned prefix of the
        first ``n_full_pages`` pages (possibly fewer than requested), with a
        reference taken for the caller — or None on a cold miss."""
        if n_full_pages <= 0:
            return None
        self._tick += 1
        pages: List[int] = []
        children = self._children
        for chunk in self._chunks(prompt_ids, n_full_pages):
            node = children.get(chunk)
            if node is None:
                break
            node.last_used = self._tick
            pages.append(node.page)
            children = node.children
        if not pages:
            return None
        self.pool.ref(pages)
        return pages

    def insert(self, prompt_ids: Sequence[int], pages: List[int]):
        """Register a freshly covered page chain (shared prefix + newly
        prefilled pages). Existing nodes are kept — a racing identical
        prefill's duplicate page stays owned by its slot and is freed when
        that slot finishes; new nodes take their own reference."""
        self._tick += 1
        children = self._children
        for chunk, page in zip(self._chunks(prompt_ids, len(pages)), pages):
            node = children.get(chunk)
            if node is None:
                self.pool.ref([page])
                node = _RadixNode(page=page, children={}, last_used=self._tick)
                children[chunk] = node
                self._n_nodes += 1
            else:
                node.last_used = self._tick
            children = node.children

    def n_reclaimable(self) -> int:
        """Pages held ONLY by the registry (refcount 1) — instantly
        evictable by the next admission under pool pressure. The
        admission-control occupancy signal subtracts these: raw occupancy
        counts cache an idle server would happily evict, which reads as
        "full" to an external admission gate and livelocks it."""
        out = 0
        stack = list(self._children.values())
        while stack:
            n = stack.pop()
            if self.pool.refcount(n.page) == 1:
                out += 1
            stack.extend(n.children.values())
        return out

    def evict_lru(self, n_pages_needed: int) -> int:
        """Drop least-recently-used LEAVES (a node only goes after all its
        descendants) until the pool could satisfy ``n_pages_needed``. Nodes
        whose page is still borrowed by a running slot (refcount > 1) are
        SKIPPED, not dropped — releasing them frees nothing until the slot
        finishes, so evicting would drain hot prefixes under transient
        pressure without yielding a single page. One DFS collects every
        node; parents become evictable as their children go — O(tree)
        total, not O(tree) per page. Returns pages evicted."""
        if self.pool.n_free >= n_pages_needed:
            return 0
        import heapq

        # one DFS: entry = [parent_children, key, node, n_live_children, idx]
        entries: List[list] = []
        parent_idx: Dict[int, int] = {}
        stack = [(self._children, k, n, None) for k, n in self._children.items()]
        while stack:
            pc, k, n, pidx = stack.pop()
            i = len(entries)
            entries.append([pc, k, n, len(n.children)])
            if pidx is not None:
                parent_idx[i] = pidx
            stack.extend((n.children, ck, cn, i) for ck, cn in n.children.items())
        heap = [
            (e[2].last_used, i) for i, e in enumerate(entries) if e[3] == 0
        ]
        heapq.heapify(heap)
        evicted = 0
        while heap and self.pool.n_free < n_pages_needed:
            _, i = heapq.heappop(heap)
            pc, k, n, _ = entries[i]
            if self.pool.refcount(n.page) > 1:
                # borrowed by a resident slot: evicting frees nothing and
                # loses the prefix; leave this subtree alone
                continue
            self.pool.release([n.page])
            del pc[k]
            self._n_nodes -= 1
            evicted += 1
            pi = parent_idx.get(i)
            if pi is not None:
                entries[pi][3] -= 1
                if entries[pi][3] == 0:
                    heapq.heappush(heap, (entries[pi][2].last_used, pi))
        return evicted

    def clear(self):
        """Invalidate everything (weight update)."""
        stack = list(self._children.values())
        while stack:
            n = stack.pop()
            self.pool.release([n.page])
            stack.extend(n.children.values())
        self._children = {}
        self._n_nodes = 0
