"""Block-paged KV pool: refcounted, prefix-shared, copy-on-write pages.

One pool backs one tenant lane.  Physical pages live in the lane's cache
arrays as ``(n_pages + 1, page_size, kv_heads, head_dim)`` — index 0 is a
reserved **null page** that is never allocated: unwritten page-table
entries point at it, so pad/out-of-range scatter writes land there
harmlessly and gathers through an unallocated entry read zeros that the
length mask excludes exactly.

Allocation is whole-lifetime: a request's full page need
(``pages_for(min(prompt_len + max_new - 1, max_len))``) is claimed at
admission and reclaimed in one shot at completion.  Pages are
**refcounted**: several rows' tables may alias one physical page (prefix
sharing), and a page returns to the free list only when its last
reference drops.  The conservation invariant is refcount-aware and holds
exactly at every step:

    pages_in_use + pages_free == n_pages          (distinct pages)
    sum(refcounts)            == total page-table entries

Prefix sharing: when a row's prompt finishes prefill, the pool indexes
its fully-written whole pages under a **rolling chain key**
``(parent_phys, page_tokens)`` — the physical id of the page's
predecessor in the chain (-1 at the root) plus the ``page_size`` tokens
the page itself covers.  The parent id was itself indexed under *its*
whole chain, so by induction a hit still pins the page's K/V content
byte-for-byte to the full cumulative token prefix (cache content is a
deterministic function of the token prefix) — but each key hashes only
``page_size`` tokens, making prompt indexing O(plen) total where the
old cumulative-tuple keys (page j keyed on ``T[:(j+1)*page_size]``)
cost O(plen²).  ``index_ops`` counts token positions hashed;
tests/test_kv_pool.py pins the linear scaling.  A later admission with
a matching head aliases indexed pages instead of recomputing them.
Because chain keys embed a *recyclable* physical id, every key that
names a page as its parent is also registered for cleanup under that
parent: when the parent's last reference drops, those keys leave the
index with it, so a recycled id can never satisfy a stale
``(parent, page_tokens)`` lookup and alias K/V computed under a
different prefix (tests/test_kv_pool.py pins the regression).
Sharing always stops at least one token short of the prompt end (the
final token must flow through the model to produce the first output
logits), and a sub-page extension match (the next page's tokens agree
for ``r < page_size`` positions) may alias one partial page.

Copy-on-write: a row that would write its *own* tokens into a shared
page (the partial-page cases above) privatizes it first — the pool
claims a fresh page, drops one reference on the shared original, and
hands the caller a ``(src, dst)`` device-copy obligation.  After COW the
two rows' tables never alias that logical position again.

``budget`` is the QoS view of the same pool: a logical cap (<= the
physical ``n_pages``) that ``BatchScheduler.set_weights`` re-splits at
step boundaries.  Shrinking the budget below current usage only blocks
new admissions; resident pages drain as requests complete.  The budget
gates *admission plans* (``can_alloc`` / ``can_alloc_shared``) —
mid-life COW is accounted in the plan that admitted the row, never
re-gated.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NULL_PAGE = 0


class PagedKVPool:
    """Refcounted free-list page allocator with per-row (per-slot) page
    tables and a whole-page prefix index for cross-request sharing."""

    def __init__(self, n_pages: int, page_size: int, max_len: int,
                 n_rows: int):
        if page_size <= 0:
            raise ValueError(f"page_size must be > 0, got {page_size}")
        if max_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_len {max_len}: the "
                f"gathered logical view must be exactly max_len wide for "
                f"bit-exactness with the dense cache path")
        if n_pages < 1:
            raise ValueError(f"pool needs >= 1 page, got {n_pages}")
        self.page_size = page_size
        self.max_len = max_len
        self.n_rows = n_rows
        self.n_pages = n_pages
        self.pages_per_seq = max_len // page_size
        self._budget = n_pages
        # physical ids n_pages..1 so pop() hands out low ids first;
        # id 0 is the null page and never enters the free list
        self._free: List[int] = list(range(n_pages, 0, -1))
        self._rows: List[List[int]] = [[] for _ in range(n_rows)]
        # refcounts for every allocated physical page (absent == free)
        self._ref: Dict[int, int] = {}
        # prefix index, rolling chain keys: (parent_phys | -1, the page's
        # own page_size tokens) -> physical page.  The parent id stands
        # in for the whole chain before the page (it was indexed under
        # ITS chain), so a hit pins content exactly while hashing O(ps)
        # tokens per key instead of the whole cumulative prefix; _ext
        # maps parent_phys | -1 -> (phys, page tokens) of the first page
        # registered after it, for sub-page extension matches
        self._prefix: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._ext: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # reverse map: phys page -> index records to purge when the page
        # leaves the pool (refcount 0), BEFORE the free list can recycle
        # the id under different contents.  Two record flavors per page:
        # keys whose VALUE is the page, and keys that EMBED the page's
        # id as the chain parent.  The second flavor is load-bearing: a
        # registration that hits an existing key chains off the CANONICAL
        # page (which the registering row may not reference at all), so
        # refcount(parent) >= refcount(child) does NOT hold in general —
        # the parent can free first, and any surviving (parent, tokens)
        # key would silently alias wrong-content K/V once the id is
        # recycled.  _drop_index therefore removes both flavors.
        self._page_keys: Dict[int, List[Tuple[str, object]]] = {}
        # token positions hashed while building index keys (register +
        # plan) — the admission-cost counter the O(plen) test pins
        self.index_ops = 0

    # -- sizing ---------------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` cache positions.

        ``pages_for(0) == 0``: a row holding no tokens claims no pages
        (admission sizes rows by ``min(prompt_len + max_new - 1,
        max_len)``, which is >= 1 for any real request, so the old
        floor of 1 was dead weight — and wrong for the share planner,
        which sizes partial spans).  Sizing clamps at ``max_len``
        because the cache is ``max_len`` deep: the scheduler never
        admits a prompt with ``prompt_len - 1 >= max_len`` and caps the
        lifetime claim at ``max_len`` tokens, so a row can never need
        more than ``pages_per_seq`` pages.
        """
        if n_tokens <= 0:
            return 0
        return -(-min(n_tokens, self.max_len) // self.page_size)

    @property
    def pages_in_use(self) -> int:
        """Distinct physical pages allocated.  Refcount-aware: a page
        aliased by k rows counts once, not k times."""
        return self.n_pages - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_owned(self) -> int:
        """Allocated pages with exactly one referencing row."""
        return sum(1 for c in self._ref.values() if c == 1)

    @property
    def pages_shared(self) -> int:
        """Allocated pages aliased by two or more rows."""
        return sum(1 for c in self._ref.values() if c >= 2)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def row_pages(self, row: int) -> List[int]:
        return list(self._rows[row])

    def row_shared_pages(self, row: int) -> int:
        """How many of ``row``'s pages are currently aliased."""
        return sum(1 for p in self._rows[row] if self._ref.get(p, 0) >= 2)

    @property
    def budget(self) -> int:
        return self._budget

    def set_budget(self, n: int) -> None:
        """Re-cap the QoS budget (clamped to [1, n_pages]).

        Shrinking below ``pages_in_use`` — including when some of that
        usage is refcounted shared pages — only gates NEW admissions:
        resident rows keep every page (shared or owned) until they
        complete, and the pool drains under the new cap naturally.
        """
        self._budget = max(1, min(int(n), self.n_pages))

    def conservation_ok(self) -> bool:
        """The exit-gate invariant, refcount-aware:

        * distinct allocated + free == n_pages,
        * every allocated page has a refcount (and only those),
        * sum of refcounts == total page-table entries across rows,
        * the null page is never allocated and never in the free list.
        """
        entries = sum(len(r) for r in self._rows)
        return (self.pages_in_use + self.pages_free == self.n_pages
                and len(self._ref) == self.pages_in_use
                and sum(self._ref.values()) == entries
                and NULL_PAGE not in self._ref
                and NULL_PAGE not in self._free
                and not set(self._free) & set(self._ref))

    # -- alloc / free ---------------------------------------------------------

    def _pop_free(self) -> int:
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def can_alloc(self, n_tokens: int) -> bool:
        need = self.pages_for(n_tokens)
        return (need <= self.pages_free
                and self.pages_in_use + need <= self._budget)

    def alloc(self, row: int, n_tokens: int) -> List[int]:
        """Claim all pages for a sequence of ``n_tokens`` onto ``row``
        (private — no sharing; see :meth:`alloc_shared`).

        Returns the physical page ids (logical order).  Raises if the row
        already owns pages or the pool/budget cannot satisfy the request —
        callers gate on :meth:`can_alloc` (admission backpressure; the
        scheduler queues rather than drops).
        """
        if self._rows[row]:
            raise RuntimeError(f"row {row} already owns pages "
                               f"{self._rows[row]}")
        if not self.can_alloc(n_tokens):
            raise RuntimeError(
                f"pool cannot allocate {self.pages_for(n_tokens)} pages "
                f"(free={self.pages_free}, in_use={self.pages_in_use}, "
                f"budget={self._budget})")
        pages = [self._pop_free() for _ in range(self.pages_for(n_tokens))]
        self._rows[row] = pages
        return pages

    def free_row(self, row: int) -> List[int]:
        """Drop one reference on each of a row's pages; pages whose last
        reference drops return to the free list (and leave the prefix
        index — a recycled id must never be reachable under stale
        token keys)."""
        pages = self._rows[row]
        self._rows[row] = []
        for page in reversed(pages):
            left = self._ref[page] - 1
            if left:
                self._ref[page] = left
            else:
                del self._ref[page]
                self._drop_index(page)
                self._free.append(page)
        return pages

    # -- prefix sharing -------------------------------------------------------

    def register_prefix(self, row: int, tokens: Sequence[int]) -> int:
        """Index ``row``'s fully-written whole pages for future sharing.

        Call when the row's prefill completes: every page wholly covered
        by ``tokens`` is final (decode writes land past the prompt), so
        its contents are exactly the K/V of its token chain.  First
        registration of a chain wins; duplicates are no-ops.  Returns
        the number of pages newly indexed.
        """
        toks = tuple(int(t) for t in tokens)
        pages = self._rows[row]
        ps = self.page_size
        added = 0
        parent = -1                        # chain root (no predecessor)
        for j in range(min(len(toks) // ps, len(pages))):
            page_toks = toks[j * ps:(j + 1) * ps]
            self.index_ops += ps
            key = (parent, page_toks)
            hit = self._prefix.get(key)
            if hit is not None:
                # chain already indexed: keep walking down the CANONICAL
                # phys chain so later keys parent off the indexed pages,
                # not this row's duplicate copies
                parent = hit
                continue
            phys = pages[j]
            self._prefix[key] = phys
            self._page_keys.setdefault(phys, []).append(("p", key))
            if parent != -1:
                # the key embeds the parent's phys id — make it reachable
                # from the parent too, so _drop_index(parent) purges it
                # even when this row holds no reference on the parent
                # (the stale-key recycling hazard; see _page_keys above)
                self._page_keys.setdefault(parent, []).append(("p", key))
            added += 1
            if parent not in self._ext:
                self._ext[parent] = (phys, page_toks)
                self._page_keys[phys].append(("e", parent))
                if parent != -1:
                    self._page_keys[parent].append(("e", parent))
            parent = phys
        return added

    def _drop_index(self, phys: int) -> None:
        """Purge every index entry that could resolve through ``phys``
        once its id recycles: keys whose value is the page, AND keys /
        ``_ext`` slots that embed its id as the chain parent.  Records
        left behind in a *child's* list after its parent-key was purged
        here are harmless: the guards below no-op on a missing key, and
        a key re-created under a recycled parent id never matches the
        stale record's value test."""
        for kind, key in self._page_keys.pop(phys, ()):
            if kind == "p":
                if key[0] == phys or self._prefix.get(key) == phys:
                    self._prefix.pop(key, None)
            else:
                entry = self._ext.get(key)
                if key == phys or (entry is not None and entry[0] == phys):
                    self._ext.pop(key, None)

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)

    def plan_shared(self, n_tokens: int,
                    tokens: Sequence[int]) -> Dict[str, object]:
        """Admission plan for ``tokens`` with a whole-lifetime claim of
        ``n_tokens`` positions: how many pages alias the prefix index,
        how many tokens of prefill that skips, whether the last aliased
        page needs copy-on-write, and whether the fresh-page remainder
        fits the pool and budget.
        """
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        total = self.pages_for(n_tokens)
        chain: List[int] = []
        parent = -1
        while (len(chain) + 1) * ps <= len(toks):
            page_toks = toks[len(chain) * ps:(len(chain) + 1) * ps]
            self.index_ops += ps
            phys = self._prefix.get((parent, page_toks))
            if phys is None:
                break
            chain.append(phys)
            parent = phys
        m = len(chain)
        # sub-page extension: the indexed page after the matched chain
        # may share a head of its tokens with ours — alias it and COW
        ext_phys: Optional[int] = None
        r = 0
        rest = toks[m * ps:]
        ext = self._ext.get(parent) if rest else None
        if ext is not None:
            phys, content = ext
            while r < min(len(rest), ps) and rest[r] == content[r]:
                r += 1
            if r:
                ext_phys = phys
        # never share the whole prompt: the final token must be fed so
        # the window closure emits the first output token
        s_tok = min(m * ps + r, len(toks) - 1) if toks else 0
        n_alias = min(self.pages_for(s_tok), total)
        aliased = (chain + ([ext_phys] if ext_phys is not None else []))
        aliased = aliased[:n_alias]
        # a partially-covered aliased page takes this row's own tokens
        # at positions >= s_tok: privatize it (one fresh page) first
        cow = 1 if (s_tok % ps and n_alias) else 0
        fresh = total - n_alias + cow
        return {"total": total, "aliased": aliased, "shared_tokens": s_tok,
                "cow": cow, "fresh": fresh,
                "fits": (fresh <= self.pages_free
                         and self.pages_in_use + fresh <= self._budget)}

    def can_alloc_shared(self, n_tokens: int,
                         tokens: Sequence[int]) -> bool:
        return bool(self.plan_shared(n_tokens, tokens)["fits"])

    def alloc_shared(self, row: int, n_tokens: int,
                     tokens: Sequence[int]
                     ) -> Tuple[List[int], int, List[Tuple[int, int]]]:
        """Claim ``row``'s pages, aliasing indexed prefix pages where
        the token chain matches.

        Returns ``(pages, shared_tokens, cow_pairs)``: the row's full
        page list, how many leading token positions arrive pre-written
        through the aliased pages (the scheduler starts the fill marker
        and the chunked-prefill cursor there), and the ``(src, dst)``
        device page copies the caller MUST apply before the row's first
        write — each pair is a copy-on-write privatization already
        reflected in the page table.
        """
        if self._rows[row]:
            raise RuntimeError(f"row {row} already owns pages "
                               f"{self._rows[row]}")
        plan = self.plan_shared(n_tokens, tokens)
        if not plan["fits"]:
            raise RuntimeError(
                f"pool cannot admit shared plan {plan} "
                f"(free={self.pages_free}, in_use={self.pages_in_use}, "
                f"budget={self._budget})")
        pages: List[int] = []
        for p in plan["aliased"]:
            self._ref[p] += 1
            pages.append(p)
        for _ in range(plan["total"] - len(pages)):
            pages.append(self._pop_free())
        self._rows[row] = pages
        cow_pairs: List[Tuple[int, int]] = []
        if plan["cow"]:
            pair = self.cow(row, len(plan["aliased"]) - 1)
            if pair is not None:
                cow_pairs.append(pair)
        return pages, int(plan["shared_tokens"]), cow_pairs

    def cow(self, row: int, logical: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: make ``row``'s page at ``logical`` private.

        No-op (returns ``None``) when the page is already singly
        referenced.  Otherwise claims a fresh page, retargets the row's
        table at it, drops one reference on the shared original, and
        returns ``(src, dst)`` — the caller owns copying the device
        page contents before the row's next write lands.  After this,
        the row's entry no longer aliases any other row's.
        """
        phys = self._rows[row][logical]
        if self._ref.get(phys, 0) <= 1:
            return None
        if not self._free:
            raise RuntimeError(
                "copy-on-write needs a free page but the pool is "
                "exhausted; admission plans must reserve COW pages "
                "up front (plan_shared does)")
        new = self._pop_free()
        self._ref[phys] -= 1
        self._rows[row][logical] = new
        return phys, new

    # -- table views ----------------------------------------------------------

    def table_row(self, row: int) -> np.ndarray:
        """(pages_per_seq,) int32 physical ids; NULL_PAGE past the end."""
        out = np.full((self.pages_per_seq,), NULL_PAGE, np.int32)
        pages = self._rows[row]
        out[:len(pages)] = pages
        return out

    def table(self) -> np.ndarray:
        """(n_rows, pages_per_seq) int32 page table for the whole lane."""
        return np.stack([self.table_row(r) for r in range(self.n_rows)])

    def report(self) -> dict:
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "pages_per_seq": self.pages_per_seq,
                "pages_in_use": self.pages_in_use,
                "pages_free": self.pages_free,
                "pages_owned": self.pages_owned,
                "pages_shared": self.pages_shared,
                "prefix_entries": self.prefix_entries,
                "index_ops": self.index_ops,
                "budget": self._budget,
                "conservation_ok": self.conservation_ok()}


def default_pool_pages(n_rows: int, max_len: int, page_size: int,
                       kv_pages: Optional[int] = None) -> int:
    """Pool sizing: ``kv_pages`` when the operator set one, else enough
    for every row to hold a full-depth sequence (never blocks)."""
    if kv_pages is not None:
        return kv_pages
    return n_rows * (max_len // page_size)
