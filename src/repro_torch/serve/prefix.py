"""Host-side prefix index: a radix trie over full KV pages (DESIGN.md §5.4).

A copy of ``repro.serve.prefix`` (pure Python): the port keeps its own so
it never imports the JAX package.  Its tests are
``tests/test_torch_lifecycle.py``'s ports of ``tests/test_prefix.py``.

The paged pool (DESIGN.md §5.2) makes prompt-prefix sharing a pure
page-table operation: if the first ``m`` full pages of a new request's
prompt are already resident — written by an earlier request with the same
token prefix — the new slot's page table can simply alias those physical
pages and prefill only the unshared suffix.  This trie is the host-side
directory that answers "which resident pages hold this token prefix?".

Structure
---------
Each node represents ONE full page of tokens: its edge key is the page's
token content (a ``page_size``-tuple — the "token hash" is Python's tuple
hash in the children dict) and it records the physical page id holding
that content.  A root→node path therefore spells out a full-page token
prefix and the physical page chain backing it.

Invariants (unit-tested in ``tests/test_prefix.py``):

* **Full pages only.**  A partial page is never registered or matched: the
  trailing ``len(tokens) % page_size`` tokens of a prompt live in a
  private page (and the serve engine additionally caps sharing so the
  prompt's last token is always re-prefilled — the logits that seed
  decoding are computed fresh, never assumed resident).
* **Registered pages are immutable.**  Only pages fully covered by a
  request's *prompt* are registered; the cursor only ever advances past
  them, and the engine's scatter can't write below a slot's cursor — so a
  shared page is never mutated.  Divergence is copy-on-write by
  *allocation*: the first divergent page is always a freshly allocated
  private page, never a write into a shared one.
* **The trie holds no references.**  Residency is owned by the engine's
  refcounted ``PageAllocator`` (one reference per slot whose table maps
  the page).  When a page's refcount hits zero the allocator frees it and
  the engine calls :meth:`evict` — unless the adaptive policy *retains*
  it in the allocator's bounded warm tier (DESIGN.md §5.7), in which
  case the node stays attachable: a later request with the same prefix
  revives the page to refcount 1 without re-prefilling.  Because every
  sharer references the whole chain, a parent page can never free before
  its children — nodes evict leaf-upward (asserted) — and a warm node's
  children are never held (a held child implies a held parent).
"""
from __future__ import annotations


class _Node:
    """One full page of tokens: ``key`` is its content (page_size-tuple of
    ints) under ``parent``; ``page`` the physical page id backing it."""

    __slots__ = ("parent", "key", "page", "children", "depth")

    def __init__(self, parent, key, page: int):
        self.parent = parent
        self.key = key
        self.page = page
        self.children: dict[tuple, _Node] = {}
        self.depth = 0 if parent is None else parent.depth + 1


class PrefixIndex:
    """Radix trie mapping full-page token prefixes to resident page ids."""

    def __init__(self, page_size: int):
        assert page_size > 0, f"page_size={page_size}"
        self.page_size = page_size
        self._root = _Node(None, None, -1)
        self._by_page: dict[int, _Node] = {}

    def __len__(self) -> int:
        """Number of resident (registered, not yet evicted) trie nodes."""
        return len(self._by_page)

    def chunks(self, tokens) -> list[tuple[int, ...]]:
        """Full-page token chunks of ``tokens``; the partial tail (if any)
        is dropped — partial pages never participate in sharing.  The
        engine computes this once per admission and passes it to both
        :meth:`lookup` and :meth:`register` (the per-token tuple build is
        the only O(prompt) work on the admission host path)."""
        psz = self.page_size
        return [
            tuple(int(t) for t in tokens[i * psz:(i + 1) * psz])
            for i in range(len(tokens) // psz)
        ]

    def lookup(self, tokens, chunks=None) -> list[int]:
        """Longest-match: physical page ids of the longest resident chain
        of full pages prefixing ``tokens`` (possibly empty)."""
        node, pages = self._root, []
        for chunk in self.chunks(tokens) if chunks is None else chunks:
            node = node.children.get(chunk)
            if node is None:
                break
            pages.append(node.page)
        return pages

    def register(self, tokens, pages, chunks=None) -> list[int]:
        """Index the full-page prefix of ``tokens``, backed by physical
        ``pages`` (one id per full page — the admitting slot's page table).

        Chunks already resident keep their existing node (the caller
        shares those pages instead of duplicating them); only chunks with
        no resident node create one, and those always map pages the
        caller privately owns.  Returns the newly registered page ids.
        """
        if chunks is None:
            chunks = self.chunks(tokens)
        assert len(pages) >= len(chunks), (
            f"register: {len(chunks)} full pages of tokens but only "
            f"{len(pages)} page ids"
        )
        node, registered = self._root, []
        for chunk, pid in zip(chunks, pages):
            nxt = node.children.get(chunk)
            if nxt is None:
                pid = int(pid)
                assert pid >= 0, f"register: unmapped page id {pid}"
                assert pid not in self._by_page, (
                    f"page {pid} already registered under another prefix"
                )
                nxt = _Node(node, chunk, pid)
                node.children[chunk] = nxt
                self._by_page[pid] = nxt
                registered.append(pid)
            node = nxt
        return registered

    def evict(self, page_ids) -> int:
        """Drop the nodes backing ``page_ids`` (pages whose refcount just
        hit zero).  Unregistered ids are ignored (tail/decode pages are
        never in the trie).  Children free no later than parents — every
        sharer holds the whole chain — so eviction proceeds leaf-upward;
        a node evicted while a child is still resident is a refcount bug
        and asserts.  Returns the number of nodes evicted."""
        nodes = [
            self._by_page.pop(pid)
            for pid in page_ids if pid in self._by_page
        ]
        for node in sorted(nodes, key=lambda n: -n.depth):
            assert not node.children, (
                f"evicting trie node for page {node.page} while "
                f"{len(node.children)} child page(s) are still resident "
                "(parent freed before child — refcount invariant broken)"
            )
            del node.parent.children[node.key]
        return len(nodes)

    def depth_of(self, page_id: int) -> int:
        """1-based chain depth of a registered page (root child = 1), or
        0 if the page is not registered.  The warm-retention policy
        (DESIGN.md §5.7) retains shallowest-first so the warm set stays a
        depth-prefix of its chain — a warm page's ancestors are either
        held (some sharer still resident) or warm, never reclaimed out
        from under it."""
        node = self._by_page.get(page_id)
        return node.depth if node is not None else 0

    def parent_page(self, page_id: int) -> int | None:
        """Physical page id of a registered page's parent node, or None
        for a depth-1 page (root child) / an unregistered page."""
        node = self._by_page.get(page_id)
        if node is None or node.parent is None or node.parent.parent is None:
            return None
        return node.parent.page

    def subtree_pages(self, page_id: int) -> list[int]:
        """All registered page ids in the subtree rooted at ``page_id``
        (inclusive), parents before children — or [] if unregistered.
        Reclaiming/quarantining a warm page must close over its warm
        descendants (evicting a node whose children are still resident
        asserts); callers evict in REVERSE of this order (leaf-upward)."""
        node = self._by_page.get(page_id)
        if node is None:
            return []
        out, stack = [], [node]
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    def resident_tokens(self) -> int:
        """Total prompt tokens currently indexed (nodes x page_size)."""
        return len(self._by_page) * self.page_size

    def resident_pages(self) -> set[int]:
        """Physical page ids currently indexed.  The trie holds no
        references, so every one of these MUST be held OR warm in the
        allocator — the engine's ``check_invariants`` asserts exactly
        that (a trie page outliving its last reference without warm
        retention would alias freed storage)."""
        return set(self._by_page)
