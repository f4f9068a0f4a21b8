"""Radix-tree prefix index over block-aligned token-id chunks (the
port's own copy of ``tpulab.kvcache.radix``, pure Python).

The tree maps *token chunks* (one chunk per KV block, ``block_size``
token ids each) to KV-pool block indices, one node per block.  Where the
dict prefix cache answers exact-key probes only, a radix walk returns the
longest *partial* hit (any block-aligned prefix of any cached prefix), so
a prompt that diverges from a cached conversation three blocks in still
reuses those three blocks.

Contracts the engine relies on:

* ``insert`` returns only the blocks adopted by newly created nodes: the
  engine takes exactly one cache reference per adopted block, so a block
  shared by many cached prefixes holds a single cache reference (one node
  per block).
* Eviction is leaf-only, LRU by a deterministic monotonic clock (no wall
  time), so an interior block is never freed while a deeper cached suffix
  still chains through it.
* ``lookup`` and ``insert`` freshen every node on the walked path,
  deepest last, so a recently used path evicts leaf first in reverse
  depth order.

Blocks are opaque ints here, which keeps the module testable against a
brute-force oracle.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

Chunk = Tuple[int, ...]


class _Node:
    __slots__ = ("chunk", "block", "parent", "children", "last_use",
                 "terminal")

    def __init__(self, chunk: Chunk, block: int,
                 parent: Optional["_Node"]) -> None:
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[Chunk, "_Node"] = {}
        self.last_use = 0
        self.terminal = False


class RadixPrefixIndex:
    """Block-granular radix tree: longest-partial prefix lookup,
    leaf-only LRU eviction, one cache reference per node."""

    def __init__(self, block_size: int) -> None:
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = int(block_size)
        self._root = _Node((), -1, None)
        self._clock = 0
        self._n_nodes = 0
        self._n_entries = 0

    # -- internals ----------------------------------------------------
    def _chunks(self, tokens: Sequence[int]) -> List[Chunk]:
        bs = self.block_size
        n = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n)]

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    # -- queries ------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        """Number of nodes == number of cache-referenced blocks."""
        return self._n_nodes

    @property
    def n_entries(self) -> int:
        """Number of registered prefixes (terminal nodes)."""
        return self._n_entries

    def __len__(self) -> int:
        return self._n_entries

    def blocks(self) -> Iterator[int]:
        """Every block the index holds a cache reference on."""
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node.block
            stack.extend(node.children.values())

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest partial hit: walk whole-chunk matches from the root.

        Returns ``(blocks, n_chunks)`` — the block indices of the
        matched path and how many full chunks matched.  Freshen every
        node on the path (deepest last)."""
        node = self._root
        blocks: List[int] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            node = child
            blocks.append(node.block)
            self._touch(node)
        return blocks, len(blocks)

    def insert(self, tokens: Sequence[int],
               blocks: Sequence[int]) -> List[int]:
        """Register a prefix; returns blocks adopted by NEW nodes only.

        ``blocks[i]`` is the pool block backing chunk ``i``.  Existing
        nodes keep their block (first writer wins — the pools already
        hold that block's KV, and every live path chained through it);
        the caller must take one cache reference per returned block."""
        chunks = self._chunks(tokens)
        if len(blocks) < len(chunks):
            raise ValueError(
                f"insert needs one block per chunk: {len(chunks)} chunks, "
                f"{len(blocks)} blocks")
        node = self._root
        adopted: List[int] = []
        for i, chunk in enumerate(chunks):
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(blocks[i]), node)
                node.children[chunk] = child
                self._n_nodes += 1
                adopted.append(child.block)
            node = child
            self._touch(node)
        if chunks and not node.terminal:
            node.terminal = True
            self._n_entries += 1
        return adopted

    # -- eviction -----------------------------------------------------
    def _leaves(self) -> Iterator[_Node]:
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def evict_leaf(self) -> Optional[Tuple[int, Tuple[int, ...]]]:
        """Drop the least-recently-used leaf.

        Returns ``(block, token_path)`` — the freed block and the full
        token-id path that identified it (the spill tier keys on it) —
        or ``None`` when the tree is empty.  Leaf-only: interior nodes
        become evictable once their whole subtree is gone."""
        victim: Optional[_Node] = None
        for leaf in self._leaves():
            if victim is None or leaf.last_use < victim.last_use:
                victim = leaf
        if victim is None:
            return None
        path: List[int] = []
        node: Optional[_Node] = victim
        while node is not None and node.parent is not None:
            path[:0] = node.chunk
            node = node.parent
        if victim.terminal:
            victim.terminal = False
            self._n_entries -= 1
        # an evicted leaf's parent may have been a registered prefix of
        # its own; entries above the leaf are untouched
        assert victim.parent is not None
        del victim.parent.children[victim.chunk]
        self._n_nodes -= 1
        return victim.block, tuple(path)

    def clear(self) -> None:
        self._root = _Node((), -1, None)
        self._n_nodes = 0
        self._n_entries = 0
