"""Radix index over page-granular prompt prefixes.

Counterpart of ``repro.serve.prefix_index`` (pure Python, kept as a copy
of its own: ``repro.serve`` imports JAX).  Prefix sharing is the block
tables' indirection cashed in as capacity: two prompts that start with
the same tokens produce the same K/V for those positions, so their block
tables can point at the same physical pages.  This module owns the
lookup structure, a radix tree whose edges are whole pages of token ids
(``page_size`` tokens an edge) and whose nodes carry the physical page
holding that page's K/V.

Granularity is page-level: a page is the unit the allocator moves and the
unit the paged attention kernels gather, so a prefix is shareable exactly
when it covers full pages.  A prompt's partial tail page is never
indexed: its owner keeps writing into it (suffix prefill padding, the
first decode rows), and a shared page must never see a write.

Ownership protocol (:class:`repro_torch.serve.kv_cache.PagedCacheManager`
drives it; the index never touches the allocator itself):

  * ``match(tokens)`` walks the longest indexed prefix and returns its
    pages; the caller ``share()``s them (refcount + 1) before mapping them
    into a new slot's block table.
  * ``insert(tokens, pages)`` registers a prompt's full pages after its
    prefill wrote them, and returns the pages the index newly references,
    on which the caller takes the index's own reference.  Existing nodes
    keep their page.
  * Entries whose page holds only the index's own reference are
    evictable: ``evict`` releases them leaf first, cascading, so a parent
    becomes a candidate once its children are gone.  A released request's
    prefix lingers as reusable cache and is reclaimed lazily, under
    allocation pressure.

Victim order among evictable leaves (``policy``):

  lru      least recently matched first (the default).
  lfu      least frequently matched first, ties least recently matched.
  deepest  deepest leaf first, ties least recently matched: long private
           tails go before shallow, widely shared prefixes.

``min_cached_tokens`` is the admission threshold: a prompt whose
full-page prefix holds fewer tokens is never registered.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

EVICT_POLICIES = ("lru", "lfu", "deepest")

# chain root for content-addressed prefix keys (see page_prefix_keys)
ROOT_PREFIX_KEY = b""


def chain_prefix_key(parent: bytes, page_tokens: Sequence[int]) -> bytes:
    """Content-addressed key of one page-granular prefix node: a hash
    chained over (parent key, this page's token ids).  Two prompts share
    a key exactly when they share that full-page prefix — byte-for-byte,
    with no dependence on which process, replica, or pool computed it.
    That is what lets a fleet-wide catalog say "this prefix is resident
    on replica 2" without shipping tokens or KV."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(b"|".join(str(int(t)).encode() for t in page_tokens))
    return h.digest()


def page_prefix_keys(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """The chain of content-addressed keys covering ``tokens``'s full
    pages, shallowest first: ``keys[j]`` identifies the prefix
    ``tokens[:(j+1)*page_size]``.  A router scores replica affinity by
    how many *leading* keys a replica's advertised set contains — the
    longest-indexed-prefix walk of :meth:`PrefixIndex.match`, computed
    from hashes alone."""
    keys, parent = [], ROOT_PREFIX_KEY
    for j in range(len(tokens) // page_size):
        parent = chain_prefix_key(
            parent, tokens[j * page_size:(j + 1) * page_size])
        keys.append(parent)
    return keys


class _Node:
    __slots__ = ("children", "page", "last_used", "hits", "depth")

    def __init__(self, page: int = -1, depth: int = 0):
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.page = page
        self.last_used = 0
        self.hits = 0
        self.depth = depth


class PrefixIndex:
    """Radix tree: one edge per full page of token ids -> physical page."""

    def __init__(self, page_size: int, policy: str = "lru",
                 min_cached_tokens: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1; got {page_size}")
        if policy not in EVICT_POLICIES:
            raise ValueError(f"policy must be one of {EVICT_POLICIES}; "
                             f"got {policy!r}")
        if min_cached_tokens < 0:
            raise ValueError("min_cached_tokens must be >= 0; "
                             f"got {min_cached_tokens}")
        self.page_size = page_size
        self.policy = policy
        self.min_cached_tokens = min_cached_tokens
        self._root = _Node()
        self._clock = 0          # LRU clock: bumped on match/insert
        self._n_pages = 0
        self.rejected_inserts = 0   # prompts below min_cached_tokens
        # bumped whenever the page set changes (insert/evict) — lets the
        # scheduler skip replanning a blocked admission until the answer
        # could differ (matching alone only moves LRU stamps)
        self.version = 0

    def __len__(self) -> int:
        """Number of physical pages the index currently references."""
        return self._n_pages

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def pages(self) -> Iterable[int]:
        """Every physical page the index currently references, one per
        node (the audit sweep cross-checks these against refcounts)."""
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                yield child.page
                stack.append(child)

    def _page_keys(self, tokens: Sequence[int]) -> Iterable[Tuple[int, ...]]:
        ps = self.page_size
        for j in range(len(tokens) // ps):
            yield tuple(tokens[j * ps:(j + 1) * ps])

    def prefix_keys(self) -> set:
        """Content-addressed keys of every indexed node (see
        :func:`page_prefix_keys`) — what a replica advertises to the
        fleet catalog.  Hashes only: no token ids and no KV leave the
        replica."""
        out = set()
        stack = [(self._root, ROOT_PREFIX_KEY)]
        while stack:
            node, parent = stack.pop()
            for tok_key, child in node.children.items():
                ck = chain_prefix_key(parent, tok_key)
                out.add(ck)
                stack.append((child, ck))
        return out

    # -------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Pages of the longest indexed prefix of ``tokens`` (full pages
        only).  Touches every matched entry's LRU stamp — a shared prefix
        in active use is the last thing eviction should take."""
        node, pages, t = self._root, [], self._tick()
        for key in self._page_keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = t
            child.hits += 1
            pages.append(child.page)
            node = child
        return pages

    # ------------------------------------------------------------ mutation
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> List[int]:
        """Register ``pages[j]`` as holding the K/V of token page ``j``.

        Only ``len(tokens) // page_size`` full pages are walked; ``pages``
        must supply at least that many entries.  Returns the pages the
        index newly references — the caller owns refcounting and must
        ``share()`` exactly those.  Where a node already exists, its page
        is kept (by protocol the caller mapped that same page at
        admission; a private duplicate such as a CoW fork is simply not
        registered).

        Prompts whose full-page prefix holds fewer than
        ``min_cached_tokens`` tokens are rejected outright (nothing
        registered, nothing returned): the admission threshold that keeps
        one-page one-off prompts from pinning pool pages.
        """
        full_tokens = (len(tokens) // self.page_size) * self.page_size
        if full_tokens < self.min_cached_tokens:
            self.rejected_inserts += 1
            return []
        node, new, t = self._root, [], self._tick()
        for key, page in zip(self._page_keys(tokens), pages):
            child = node.children.get(key)
            if child is None:
                child = _Node(int(page), depth=node.depth + 1)
                node.children[key] = child
                new.append(int(page))
                self._n_pages += 1
                self.version += 1
            child.last_used = t
            node = child
        return new

    # ------------------------------------------------------------ eviction
    def evictable(self, can_evict: Callable[[int], bool],
                  exclude: Optional[set] = None) -> int:
        """How many pages :meth:`evict_lru` could reclaim right now.

        A node is reclaimable when its own page passes ``can_evict``
        (typically: the index holds the only reference) and nothing in
        its subtree is pinned — leaf-first cascading can then take the
        whole chain.  ``exclude`` masks pages the caller is about to
        share (an admission must not count its own prefix as free
        capacity)."""
        exclude = exclude or set()

        def walk(node: _Node) -> Tuple[int, bool]:
            total, pinned = 0, False
            for child in node.children.values():
                sub, sub_pinned = walk(child)
                total += sub
                pinned |= sub_pinned
            if node is self._root:
                return total, pinned
            if pinned or node.page in exclude or not can_evict(node.page):
                return total, True
            return total + 1, False

        return walk(self._root)[0]

    def _victim_key(self, node: _Node):
        """Victim ordering among evictable leaves (min wins)."""
        if self.policy == "lfu":
            return (node.hits, node.last_used)
        if self.policy == "deepest":
            return (-node.depth, node.last_used)
        return (node.last_used,)                              # lru

    def evict(self, n: int, can_evict: Callable[[int], bool]) -> List[int]:
        """Drop up to ``n`` entries under the configured policy, leaves
        only (evicting a leaf may expose its parent next round).  Returns
        the freed pages; the caller releases them to the allocator."""
        freed: List[int] = []
        while len(freed) < n:
            best = None  # (victim_key, parent, key, node)
            stack: List[_Node] = [self._root]
            while stack:
                node = stack.pop()
                for key, child in node.children.items():
                    if child.children:
                        stack.append(child)
                    elif can_evict(child.page):
                        vk = self._victim_key(child)
                        if best is None or vk < best[0]:
                            best = (vk, node, key, child)
            if best is None:
                break
            _, parent, key, node = best
            del parent.children[key]
            self._n_pages -= 1
            self.version += 1
            freed.append(node.page)
        return freed

    # historical name (the policy used to be hardwired LRU); the manager
    # and older tests call this
    evict_lru = evict
