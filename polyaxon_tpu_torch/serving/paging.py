"""Host-side bookkeeping for the paged KV cache.

The port's own copy of the parts of ``polyaxon_tpu/serving/paging.py`` the
engine uses; pure Python, no tensors (the device side lives in
``models/decode.py``):

:class:`BlockAllocator` — a ref-counted free list over a fixed pool of KV
blocks.  Every in-flight sequence holds one reference per block in its
table; the shared-prefix cache holds one more per block it has published.
A block returns to the free list only when its last holder lets go, which
is what makes prefix sharing safe.

:class:`PrefixCache` — a block-granular LRU map from token-prefix hash
chains to physical blocks.  Keys are chained per block, so a lookup walks
the prompt one block at a time and stops at the first miss; the stored
token tuple is compared on every hit, so a hash collision degrades to a
miss.  Eviction only takes entries whose block has no holder but the cache.

:func:`truncate_table` — the speculative-decoding rollback of a block table.

Not ported yet (ROADMAP Queue 1 item 4): the host KV tier (``HostKVTier``,
the cache's demotion hooks) and the persistent prefix store's
``install``/``hottest_chains``.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

#: Chain seed: any fixed value distinct from real chain keys' structure.
_CHAIN_SEED = "kv-prefix"

#: Physical block 0 is never handed out: the engine points inactive lanes,
#: prompt-pad writes and unset table entries at it, so its contents are
#: garbage by design.
TRASH_BLOCK = 0


class BlockAllocator:
    """Ref-counted FIFO free list over ``num_blocks`` physical KV blocks.

    Block :data:`TRASH_BLOCK` (0) is reserved and never allocated, so a pool
    of ``num_blocks`` serves ``num_blocks - 1`` real blocks.  ``alloc()``
    returns a block with refcount 1 (or ``None`` when the pool is exhausted:
    the engine's cue to evict cached prefixes or park the request);
    ``incref``/``decref`` adjust sharing, and the last ``decref`` returns the
    block to the back of the free list, so reuse order is release order.
    """

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"need at least 2 blocks (1 usable + trash), got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self._free: deque = deque(range(1, self.num_blocks))
        self._refs: Dict[int, int] = {}

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        block = self._free.popleft()
        self._refs[block] = 1
        return block

    def incref(self, block: int) -> None:
        if block not in self._refs:
            raise ValueError(f"block {block} is not allocated")
        self._refs[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        refs = self._refs.get(block)
        if refs is None:
            raise ValueError(f"block {block} is not allocated")
        if refs == 1:
            del self._refs[block]
            self._free.append(block)
            return True
        self._refs[block] = refs - 1
        return False

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.num_blocks - 1 - len(self._free)


def truncate_table(
    table, allocator: BlockAllocator, next_pos: int, block_size: int
) -> int:
    """Speculative-decoding rollback: drop the slot's reference on every
    table entry wholly past the block that holds ``next_pos`` (entries reset
    to -1), and return how many were dropped.

    A verify step writes KV rows for every drafted token before it knows
    which the model accepts; rows that share the next-write block are
    overwritten in place (and masked until then), but later blocks hold
    nothing the sequence reads before rewriting.  Uses ``decref``, never a
    forced free, so prefix-cache shares survive.  ``table`` is the engine's
    host-side row (a mutable int array, -1 = unset), changed in place.
    """
    keep = int(next_pos) // int(block_size)
    freed = 0
    for bi in range(keep + 1, len(table)):
        block = int(table[bi])
        if block < 0:
            break  # tables fill contiguously; nothing set past here
        allocator.decref(block)
        table[bi] = -1
        freed += 1
    return freed


class PrefixCache:
    """Block-granular shared-prefix cache over a :class:`BlockAllocator`.

    ``match()`` walks a prompt's full blocks against the chain map and
    returns the longest run of cached blocks, taking one reference per
    returned block on the caller's behalf.  ``offer()`` publishes a finished
    prompt's blocks (taking the cache's own reference on each newly
    published block).  ``evict()`` reclaims LRU entries whose block nobody
    else holds.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self._alloc = allocator
        self.block_size = int(block_size)
        # chain key -> (physical block, the block's token tuple)
        self._entries: "OrderedDict[int, Tuple[int, Tuple[int, ...]]]" = OrderedDict()
        self.hits = 0
        self.lookups = 0
        self.evictions = 0
        #: Content-change counter: bumped whenever the entry set changes.
        self.mutations = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        """Block-granular hit rate over the cache's lifetime."""
        return self.hits / self.lookups if self.lookups else 0.0

    @property
    def misses(self) -> int:
        return self.lookups - self.hits

    def _keys_for(self, prompt: Sequence[int]) -> List[Tuple[int, Tuple[int, ...]]]:
        """Chained (key, tokens) per full block of the prompt."""
        out = []
        key: object = _CHAIN_SEED
        for i in range(len(prompt) // self.block_size):
            toks = tuple(prompt[i * self.block_size : (i + 1) * self.block_size])
            key = hash((key, toks))
            out.append((key, toks))
        return out

    def match(self, prompt: Sequence[int]) -> List[int]:
        """Longest cached block-prefix of ``prompt``; increfs each returned
        block (the caller owns those references)."""
        blocks: List[int] = []
        for key, toks in self._keys_for(prompt):
            self.lookups += 1
            entry = self._entries.get(key)
            if entry is None or entry[1] != toks:
                break
            block = entry[0]
            self.hits += 1
            self._entries.move_to_end(key)
            self._alloc.incref(block)
            blocks.append(block)
        return blocks

    def offer(self, prompt: Sequence[int], blocks: Sequence[int]) -> None:
        """Publish a prompt's full blocks.  ``blocks[i]`` must hold block
        ``i``'s KV; already published prefixes keep their existing block
        (first writer wins; later identical blocks stay private)."""
        for (key, toks), block in zip(self._keys_for(prompt), blocks):
            if key not in self._entries:
                self._alloc.incref(block)
                self._entries[key] = (block, toks)
                self.mutations += 1
            self._entries.move_to_end(key)

    def evict(self, need: int = 1) -> int:
        """Reclaim up to ``need`` blocks from LRU entries whose block only the
        cache still references; returns how many blocks were freed."""
        freed = 0
        for key in list(self._entries):
            if freed >= need:
                break
            block, _ = self._entries[key]
            if self._alloc.refcount(block) != 1:
                continue
            del self._entries[key]
            self._alloc.decref(block)
            self.evictions += 1
            self.mutations += 1
            freed += 1
        return freed

    def drop_all(self) -> int:
        """Evict everything evictable (shutdown, tests)."""
        return self.evict(need=len(self._entries))
