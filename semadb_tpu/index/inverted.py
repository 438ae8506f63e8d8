"""Inverted index for scalar properties (integer/float/string/stringArray).

Parity reference: shard/index/inverted/ — term → id-set postings stored
under byte-sortable keys so range/prefix queries become ordered scans
(sortable.go:9-69: sign-flipped big-endian int64, IEEE-754 flip trick for
float64, raw utf-8 for strings), operators equals/notEquals(full scan)/
startsWith(prefix)/gt/gte/lt/lte/inRange(range scan) → union
(inverted.go:168-284), case folding for strings (string.go:25-51) and
per-element array diffing with containsAll/Any algebra (array.go:28-80).

These indices stay host-side: they are pointer-chasing set algebra over
tiny postings, not matmul work. Sets are sorted uint64 numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional, Set

import numpy as np

from semadb_tpu.models import constants as C
from semadb_tpu.store.diskstore import Bucket

# ---------------------------------------------------------------------------
# Byte-sortable codecs (sortable.go)
# ---------------------------------------------------------------------------


def int64_to_sortable(v: int) -> bytes:
    """Big-endian with flipped sign bit: preserves order for negatives."""
    return struct.pack(">Q", (v + (1 << 63)) & ((1 << 64) - 1))


def sortable_to_int64(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - (1 << 63)


def float64_to_sortable(v: float) -> bytes:
    """IEEE-754 trick: flip all bits for negatives, sign bit for positives."""
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)
    else:
        bits |= 1 << 63
    return struct.pack(">Q", bits)


def sortable_to_float64(b: bytes) -> float:
    bits = struct.unpack(">Q", b)[0]
    if bits & (1 << 63):
        bits &= ~(1 << 63) & ((1 << 64) - 1)
    else:
        bits = ~bits & ((1 << 64) - 1)
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def to_sortable(value, kind: str) -> bytes:
    if kind == "integer":
        return int64_to_sortable(int(value))
    if kind == "float":
        return float64_to_sortable(float(value))
    return str(value).encode("utf-8")


# ---------------------------------------------------------------------------
# Postings codec: sorted uint64 ids
# ---------------------------------------------------------------------------


_RANGE_MAX = b"\xff" * 9  # > any 8-byte sortable key and any utf-8 string


def _encode_set(ids: Set[int]) -> bytes:
    arr = np.fromiter(sorted(ids), dtype=np.uint64, count=len(ids))
    return arr.tobytes()


def _decode_set(raw: Optional[bytes]) -> Set[int]:
    if not raw:
        return set()
    return set(int(x) for x in np.frombuffer(raw, dtype=np.uint64))


class PostingsCache:
    """Cross-transaction decoded-postings cache for one inverted bucket.

    The reference keeps hot caches alive across txns (cache/manager.go:
    116-303 shared caches; setCacheItem term sets). Without it every
    search pays a full posting decode (numpy → boxed-int set, O(n)) and
    every WRITE decodes + re-encodes the whole posting per point — a
    1M-id common term costs ~8 MB of codec work per touched point.

    Owned by the Shard (survives txns); ``rebind`` attaches the current
    txn's bucket. Mutations are copy-on-write (a reader holding the old
    set object never sees a concurrent resize) and deferred: ``flush``
    persists dirty keys once per dispatch batch, inside the same write
    txn. ``scrap`` drops everything after a failed txn (the overlay
    rolled the store back; the cache may hold the discarded mutations —
    the reference's scrapped-on-failure semantics, manager.go:123-303).

    Bounded: past ``max_ids`` cached elements the CLEAN entries drop
    wholesale (dirty ones must survive until flush)."""

    def __init__(self, max_ids: int = 8_000_000):
        self._sets: dict = {}  # key bytes -> Set[int] (committed/flushed view)
        # key -> {id: True(add) | False(remove)} — deltas staged by the
        # current write txn, applied with ONE copy per key at flush.
        # Per-op copy-on-write cost O(posting) per point (measured
        # 14.6 ms/op into a 1M-id posting); staged deltas cost O(1) per
        # op and keep the committed view untouched for concurrent
        # readers — the same visibility the store overlay gives.
        self._pending: dict = {}
        self._n_ids = 0
        self._max = max_ids
        self.bucket: Optional[Bucket] = None

    def rebind(self, bucket: Bucket) -> None:
        self.bucket = bucket

    def get(self, key: bytes) -> Set[int]:
        """Committed/flushed view (staged deltas excluded — searches in a
        concurrent read txn must not see uncommitted writes)."""
        s = self._sets.get(key)
        if s is None:
            s = _decode_set(self.bucket.get(key))
            self._admit(key, s)
        return s

    def cached_or_decode(self, key: bytes, raw: Optional[bytes]) -> Set[int]:
        """Scan helper: the store cursor already produced ``raw`` — use
        the cached decode when present, else decode + admit."""
        s = self._sets.get(key)
        if s is None:
            s = _decode_set(raw)
            self._admit(key, s)
        return s

    def _admit(self, key: bytes, s: Set[int]) -> None:
        if self._n_ids + len(s) > self._max and key not in self._pending:
            # wholesale clean-entry drop; pending keys must survive
            keep = {k: self._sets[k] for k in self._pending if k in self._sets}
            self._n_ids = sum(len(v) for v in keep.values())
            self._sets = keep
        self._sets[key] = s
        self._n_ids += len(s)

    def mutate(self, key: bytes, add: Optional[int], remove: Optional[int]) -> None:
        p = self._pending.get(key)
        if p is None:
            p = self._pending[key] = {}
        if add is not None:
            p[add] = True
        if remove is not None:
            p[remove] = False

    def flush(self) -> None:
        for key, p in self._pending.items():
            old = self.get(key)
            s = set(old)  # one copy per key per txn; readers keep `old`
            for i, keep in p.items():
                if keep:
                    s.add(i)
                else:
                    s.discard(i)
            self._n_ids += len(s) - len(old)
            if s:
                self._sets[key] = s
                self.bucket.put(key, _encode_set(s))
            else:
                self._sets.pop(key, None)
                self.bucket.delete(key)
        self._pending = {}

    def scrap(self) -> None:
        self._sets = {}
        self._pending = {}
        self._n_ids = 0


class IndexInverted:
    """Generic inverted index over one property (inverted.go IndexInverted[T]).

    With a :class:`PostingsCache` (passed by the shard's IndexManager),
    postings decode once and writes batch their encode per txn; without
    one, behaviour is the original read-modify-write per op."""

    def __init__(
        self,
        bucket: Bucket,
        kind: str,
        case_sensitive: bool = True,
        cache: Optional[PostingsCache] = None,
    ):
        self.bucket = bucket
        self.kind = kind  # "integer" | "float" | "string"
        self.case_sensitive = case_sensitive
        self.cache = cache
        if cache is not None:
            cache.rebind(bucket)

    def _transform(self, value):
        if self.kind == "string" and not self.case_sensitive:
            return str(value).casefold()
        return value

    def _key(self, value) -> bytes:
        return to_sortable(self._transform(value), self.kind)

    def _get_set(self, key: bytes) -> Set[int]:
        if self.cache is not None:
            return self.cache.get(key)
        return _decode_set(self.bucket.get(key))

    def _scan_set(self, key: bytes, raw: Optional[bytes]) -> Set[int]:
        if self.cache is not None:
            return self.cache.cached_or_decode(key, raw)
        return _decode_set(raw)

    # -- writes ------------------------------------------------------------
    def insert(self, node_id: int, value) -> None:
        key = self._key(value)
        if self.cache is not None:
            self.cache.mutate(key, add=node_id, remove=None)
            return
        s = _decode_set(self.bucket.get(key))
        s.add(node_id)
        self.bucket.put(key, _encode_set(s))

    def delete(self, node_id: int, value) -> None:
        key = self._key(value)
        if self.cache is not None:
            self.cache.mutate(key, add=None, remove=node_id)
            return
        s = _decode_set(self.bucket.get(key))
        s.discard(node_id)
        if s:
            self.bucket.put(key, _encode_set(s))
        else:
            self.bucket.delete(key)

    def update(self, node_id: int, old_value, new_value) -> None:
        if self._transform(old_value) == self._transform(new_value):
            return
        self.delete(node_id, old_value)
        self.insert(node_id, new_value)

    def flush(self) -> None:
        """Persist deferred (cached) mutations — call once per write
        batch, inside the same store txn."""
        if self.cache is not None:
            self.cache.flush()

    # -- search ------------------------------------------------------------
    def search(self, value, end_value, operator: str) -> Set[int]:
        value = self._transform(value)
        key = to_sortable(value, self.kind)
        out: Set[int] = set()
        if operator == C.OPERATOR_EQUALS:
            return self._get_set(key)
        if operator == C.OPERATOR_NOT_EQUALS:
            for k, v in self.bucket.items():
                if k != key:
                    out |= self._scan_set(k, v)
            return out
        if operator == C.OPERATOR_STARTS_WITH:
            if self.kind != "string":
                raise ValueError("startsWith only supported for string properties")
            for k, v in self.bucket.prefix_scan(key):
                out |= self._scan_set(k, v)
            return out
        # Range operators ride the stores' ordered cursors (B+tree range
        # cursor parity, inverted.go:168-284): O(matching range), not
        # O(total terms). The byte-sortable key codecs exist for this.
        # _RANGE_MAX is strictly greater than any key: sortable int64/f64
        # keys are exactly 8 bytes, and utf-8 never contains 0xff.
        lo, hi = b"", _RANGE_MAX
        include_start = include_end = True
        if operator == C.OPERATOR_GREATER_THAN:
            lo, include_start = key, False
        elif operator == C.OPERATOR_GREATER_OR_EQ:
            lo = key
        elif operator == C.OPERATOR_LESS_THAN:
            hi, include_end = key, False
        elif operator == C.OPERATOR_LESS_OR_EQ:
            hi = key
        elif operator == C.OPERATOR_IN_RANGE:
            end_value = self._transform(end_value)
            lo, hi = key, to_sortable(end_value, self.kind)
        else:
            raise ValueError(f"unknown operator {operator}")
        for k, v in self.bucket.range_scan(lo, hi):
            if (not include_start and k == lo) or (not include_end and k == hi):
                continue
            out |= self._scan_set(k, v)
        return out


class IndexInvertedArray:
    """String-array inverted index (array.go): per-element postings with
    containsAll/containsAny set algebra and element-level update diffing."""

    def __init__(
        self,
        bucket: Bucket,
        case_sensitive: bool = False,
        cache: Optional[PostingsCache] = None,
    ):
        self.inner = IndexInverted(bucket, "string", case_sensitive, cache)

    def flush(self) -> None:
        self.inner.flush()

    def insert(self, node_id: int, values: Iterable[str]) -> None:
        for v in set(values):
            self.inner.insert(node_id, v)

    def delete(self, node_id: int, values: Iterable[str]) -> None:
        for v in set(values):
            self.inner.delete(node_id, v)

    def update(self, node_id: int, old_values, new_values) -> None:
        t = self.inner._transform
        old_set = {t(v) for v in (old_values or [])}
        new_set = {t(v) for v in (new_values or [])}
        for v in old_set - new_set:
            self.inner.delete(node_id, v)
        for v in new_set - old_set:
            self.inner.insert(node_id, v)

    def search(self, values: Iterable[str], operator: str) -> Set[int]:
        sets = [self.inner.search(v, None, C.OPERATOR_EQUALS) for v in values]
        if not sets:
            return set()
        if operator == C.OPERATOR_CONTAINS_ALL:
            # copy before &=: sets[0] may be a shared cache object
            out = set(sets[0])
            for s in sets[1:]:
                out &= s
            return out
        if operator == C.OPERATOR_CONTAINS_ANY:
            out = set()
            for s in sets:
                out |= s
            return out
        raise ValueError(f"unknown operator {operator}")
