"""Radix (token-trie) index over shared KV-cache pages and state snapshots.

Maps token-id prefixes of past requests to chains of KV pages in the paged
pool (serving/kvpool.py), at page granularity: each trie edge is one
``page_size``-token block, each node owns exactly one page holding that
block's K/V. A new request walks the trie with its prompt and reuses every
matched page without re-prefilling it — the vLLM / SGLang prefix-cache idiom,
and the serving-side twin of FAME's persisted-memory context reuse (agent
turns re-send the same conversation prefix; PAPER.md §3.3).

Stateful archs (recurrent / conv / xLSTM / ring-KV — no shareable pages)
index *recurrent-state snapshots* instead: a node may own one slot of the
pooled snapshot arena (serving/kvpool.SnapshotArena) holding the model's
fixed-size state after prefilling exactly up to that node's prefix boundary.
A radix hit then restores the nearest ancestor snapshot into the slot and
prefills only the suffix — the same sublinear-prefix property, O(1) storage
per boundary instead of O(tokens). One tree is used in one mode: every node
carries a page (attention-paged) or some nodes carry a snap (snapshot mode);
never both.

Ownership / lifetime rules:

* The tree owns the pages and snapshot slots of its nodes; the page
  allocator / snapshot arena free lists own everything else. A resource is
  never in both places.
* ``match`` pins the deepest matched node (refcount) for the lifetime of the
  request; ``release`` unpins. Eviction removes only *leaf* nodes with
  refcount 0, so a pinned node's ancestors (which the request's block table
  references) can never be evicted — they have children.
* ``insert`` adopts pages from a finished request, one node per complete
  block; ``insert_snaps`` adopts snapshot slots at chosen boundaries.
  Blocks already present keep the incumbent page/snap and the duplicate is
  handed back to the caller to free (two identical prompts racing through
  prefill).
* Eviction is LRU by a logical clock bumped on every match/insert touch.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class RadixNode:
    page: int                                    # pool page holding this block
                                                 # (-1: snapshot-mode node)
    parent: Optional["RadixNode"]
    key: Optional[Tuple[int, ...]]               # edge label (page_size tokens)
    children: Dict[Tuple[int, ...], "RadixNode"] = dataclasses.field(
        default_factory=dict)
    ref: int = 0                                 # requests pinned at this node
    last: int = 0                                # logical clock of last touch
    snap: int = -1                               # snapshot-arena slot holding
                                                 # the state at this boundary
                                                 # (-1: none)


class RadixTree:
    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.root = RadixNode(page=-1, parent=None, key=None)
        self._tick = 0
        self.evicted_pages = 0          # engine.stats() reads these; token
        self.evicted_snaps = 0          # hit/miss accounting lives in the
                                        # engine (it caps the usable match)

    # ---- internals ---------------------------------------------------------
    def _touch(self, node: RadixNode):
        self._tick += 1
        while node is not None and node.key is not None:
            node.last = self._tick
            node = node.parent
        self.root.last = self._tick

    def _blocks(self, tokens) -> List[Tuple[int, ...]]:
        ps = self.page_size
        n = len(tokens) // ps
        return [tuple(tokens[i * ps:(i + 1) * ps]) for i in range(n)]

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # ---- queries -----------------------------------------------------------
    def match(self, tokens) -> Tuple[List[int], RadixNode]:
        """Longest cached prefix of ``tokens`` in whole pages.

        Returns (page chain, deepest matched node) and pins the node — call
        ``release`` when the request finishes. The caller is responsible for
        capping the usable prefix (an engine always recomputes at least the
        last prompt token to get first-token logits).
        """
        node, pages = self.root, []
        for key in self._blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            node = child
            pages.append(node.page)
        node.ref += 1
        self._touch(node)
        return pages, node

    def release(self, node: RadixNode):
        assert node.ref > 0, "release without matching match()"
        node.ref -= 1

    def nearest_snapshot(self, node: RadixNode) -> Tuple[int, int]:
        """Deepest snapshot at or above ``node``: (snap id, depth in blocks),
        or (-1, 0) when no ancestor boundary has a live snapshot. Restoring
        it and prefilling the remaining suffix reproduces the state a full
        prefill of the matched prefix would build."""
        depth = 0
        n = node
        while n.key is not None:
            depth += 1
            n = n.parent
        while node.key is not None:
            if node.snap >= 0:
                return node.snap, depth
            node, depth = node.parent, depth - 1
        return -1, 0

    def insert(self, tokens, pages: List[int]) -> List[int]:
        """Adopt ``pages`` (one per complete block of ``tokens``) into the
        trie. Returns the duplicate pages NOT adopted (already-present
        blocks) — the caller must free them."""
        blocks = self._blocks(tokens)
        assert len(pages) >= len(blocks), (len(pages), len(blocks))
        node, rejected = self.root, []
        for key, page in zip(blocks, pages):
            child = node.children.get(key)
            if child is None:
                child = RadixNode(page=page, parent=node, key=key)
                node.children[key] = child
            elif child.page != page:
                rejected.append(page)
            node = child
        self._touch(node)
        return rejected

    def insert_snaps(self, tokens, snaps: Dict[int, int]) -> List[int]:
        """Adopt snapshot slots into the trie (snapshot-mode trees: nodes
        carry no pages). ``snaps`` maps a depth in blocks (1-based: the
        boundary after that many complete blocks of ``tokens``) to the
        arena slot holding the state at that boundary. Missing path nodes
        are created with ``page=-1``. Returns the snap ids NOT adopted
        (boundary already has a snapshot, or depth out of range) — the
        caller must free them back to the arena."""
        blocks = self._blocks(tokens)
        node, rejected = self.root, []
        for depth, key in enumerate(blocks, start=1):
            child = node.children.get(key)
            if child is None:
                child = RadixNode(page=-1, parent=node, key=key)
                node.children[key] = child
            sid = snaps.get(depth, -1)
            if sid >= 0:
                if child.snap < 0:
                    child.snap = sid
                else:
                    rejected.append(sid)
            node = child
        rejected.extend(sid for depth, sid in snaps.items()
                        if sid >= 0 and not (1 <= depth <= len(blocks)))
        self._touch(node)
        return rejected

    # ---- eviction ----------------------------------------------------------
    def _evict_leaves(self, done) -> Tuple[List[int], List[int]]:
        """Remove LRU unpinned leaves until ``done(pages, snaps)`` or none
        remain. Returns the freed (pages, snaps) for the caller to return to
        the allocator / arena.

        One tree walk collects the evictable frontier into a min-heap by
        ``last``; a parent enters the heap the moment its final child is
        removed, so bulk eviction is O(N + k log N), not O(N·k).
        """
        heap = [(n.last, id(n), n) for n in self._iter_nodes()
                if not n.children and n.ref == 0]
        heapq.heapify(heap)
        pages: List[int] = []
        snaps: List[int] = []
        while heap and not done(pages, snaps):
            _, _, node = heapq.heappop(heap)
            del node.parent.children[node.key]
            if node.page >= 0:
                pages.append(node.page)
            if node.snap >= 0:
                snaps.append(node.snap)
            parent = node.parent
            if (parent.key is not None and not parent.children
                    and parent.ref == 0):
                heapq.heappush(heap, (parent.last, id(parent), parent))
        self.evicted_pages += len(pages)
        self.evicted_snaps += len(snaps)
        return pages, snaps

    def evict(self, n_pages: int) -> List[int]:
        """Free up to ``n_pages`` pages by removing LRU unpinned leaves."""
        return self._evict_leaves(lambda p, s: len(p) >= n_pages)[0]

    def evict_snaps(self, n_snaps: int) -> List[int]:
        """Free up to ``n_snaps`` snapshot slots (snapshot-mode trees).
        Snap-less leaves on the LRU frontier are removed along the way —
        they only exist as path to deeper snapshots."""
        return self._evict_leaves(lambda p, s: len(s) >= n_snaps)[1]

    # ---- introspection -----------------------------------------------------
    def keyspace_digest(self) -> frozenset:
        """Cheap summary of which prompt keyspaces this tree caches: the
        hashes of the FIRST-block edge labels (the root's children — one per
        distinct leading ``page_size``-token block ever adopted). A fleet
        router compares a new prompt's first block against every replica's
        digest to land it where shared prefix pages/snapshots already live.
        O(#distinct first blocks), no tree walk; hashes (not token tuples)
        so the exported set stays small and opaque."""
        return frozenset(hash(k) for k in self.root.children)

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    @property
    def cached_pages(self) -> List[int]:
        return [n.page for n in self._iter_nodes() if n.page >= 0]

    @property
    def cached_snaps(self) -> List[int]:
        return [n.snap for n in self._iter_nodes() if n.snap >= 0]

    def check_invariants(self, snapshots: bool = False):
        """Structural invariants (property tests): refcounts non-negative,
        page/snap ids unique, parent/child links consistent. Returns the set
        of owned pages (``snapshots=False``) or snapshot slots."""
        seen = set()
        snaps = set()
        for node in self._iter_nodes():
            assert node.ref >= 0, "negative refcount"
            if snapshots:
                assert node.page < 0, "snapshot-mode node owns a page"
            else:
                assert node.page >= 0, "tree node without a page"
                assert node.page not in seen, f"page {node.page} owned twice"
                seen.add(node.page)
            if node.snap >= 0:
                assert node.snap not in snaps, f"snap {node.snap} owned twice"
                snaps.add(node.snap)
            assert node.parent.children[node.key] is node
            assert len(node.key) == self.page_size
        return snaps if snapshots else seen
