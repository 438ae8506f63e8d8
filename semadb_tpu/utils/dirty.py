"""Dirty-row tracking for incremental device-state snapshots.

The reference's durability unit is the bbolt write transaction: each txn
persists O(delta) pages of the B+tree (diskstore/diskstore.go:45-95).
Our delta journal matches that per-txn, but the periodic full snapshot
(`Shard.flush`) used to serialise the ENTIRE device state — at 10M points
that is ~10 GB of device→host readback, a synchronous stall inside a
write.

Every engine write path knows which rows it scattered (ids, slab cells,
overflow slots are all computed host-side before dispatch). Engines mark
those rows here; at flush time the shard converts row marks to chunk
indices for the snapshot's chunk grid and reads back ONLY dirty chunks.
An engine that cannot bound a mutation (refit, delete repair, capacity
growth) marks the whole array — correct by construction, never faster
than it should be.

Thread-safety: marks take a lock (engine write paths may run from
concurrent shard txn threads); ``collect`` drains under the same lock.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np

ALL = None  # sentinel: whole array dirty


class DirtyTracker:
    """Accumulates dirty ROW indices per (flattened) array name.

    ``rows(name, rows)``  — mark specific axis-0 rows of one array.
    ``all(name)``         — mark one array entirely.
    ``everything()``      — mark every array (refit / load / unknown op).

    ``collect()`` returns ``(everything, {name: rows|ALL})`` without
    clearing; ``clear()`` resets after a successful flush. Names not
    present in the marks are CLEAN only when ``everything`` is False.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._rows: Dict[str, Optional[list]] = {}
        self._everything = True  # a fresh tracker has no snapshot yet

    @property
    def active(self) -> bool:
        """False while the whole state is already marked dirty — callers
        can skip the work of computing fine-grained row sets (e.g. the
        vamana backedge-target readback) when marks would be ignored."""
        with self._mu:
            return not self._everything

    def rows(self, name: str, rows: Iterable[int] | np.ndarray) -> None:
        r = np.asarray(rows, np.int64).reshape(-1)
        if r.size == 0:
            return
        with self._mu:
            cur = self._rows.get(name, [])
            if cur is ALL:
                return
            cur.append(r)
            self._rows[name] = cur

    def all(self, name: str) -> None:
        with self._mu:
            self._rows[name] = ALL

    def everything(self) -> None:
        with self._mu:
            self._everything = True
            self._rows.clear()

    def collect(self) -> tuple[bool, Dict[str, Optional[np.ndarray]]]:
        with self._mu:
            if self._everything:
                return True, {}
            out: Dict[str, Optional[np.ndarray]] = {}
            for name, parts in self._rows.items():
                if parts is ALL:
                    out[name] = ALL
                else:
                    out[name] = np.unique(np.concatenate(parts))
            return False, out

    def clear(self) -> None:
        with self._mu:
            self._everything = False
            self._rows.clear()
