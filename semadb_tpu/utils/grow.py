"""Shared device-array capacity growth policy.

Every distinct capacity is a distinct XLA program: the query/write
kernels retrace and recompile (cached across processes by the persistent
compile cache, ``utils/compilecache.py``). Naive doubling from a 128-row
floor costs ~14 compiles on the way to 1M rows. This policy trades a
little device memory for far fewer shapes:

- the FIRST growth jumps straight to a floor bucket — `GROW_MIN_ROWS`
  rows, shrunk for wide rows so the floor never exceeds
  `GROW_MIN_BYTES` (a tiny empty collection still starts at the
  caller's initial capacity and costs nothing until it grows);
- subsequent growths multiply by `GROW_FACTOR` (default 4×).

Default schedule at 128d: 128 → 4096 → 16384 → 65536 → 262144 → 1M —
5 buckets instead of 14, worst-case vector-array overshoot 4× (the
rerank matrix only; cluster slabs / graph adjacency are sized by their
own fit logic). The reference has no analog: Go code has no shape
compilation. Knobs: SEMADB_GROW_FACTOR, SEMADB_GROW_MIN_ROWS,
SEMADB_GROW_MIN_BYTES.
"""

from __future__ import annotations

import os

GROW_FACTOR = max(2, int(os.environ.get("SEMADB_GROW_FACTOR", 4)))
GROW_MIN_ROWS = int(os.environ.get("SEMADB_GROW_MIN_ROWS", 4096))
GROW_MIN_BYTES = int(os.environ.get("SEMADB_GROW_MIN_BYTES", 2**23))
# Above this many bytes per array the factor drops to 2×: at multi-GB
# sizes a 4× jump wastes HBM (12M×128d = 6 GB for a 3.1M-point index)
# and compiles are already rare.
GROW_BIG_BYTES = int(os.environ.get("SEMADB_GROW_BIG_BYTES", 2**29))
# Deployments that know their corpus size skip every growth event (and
# its re-pad + recompile) by pre-growing: engines start at a capacity
# holding this many rows. bbolt never charges a user txn O(state)
# (diskstore.go:45-95) — with pre-grow, neither do we.
PREGROW_ROWS = int(os.environ.get("SEMADB_PREGROW_ROWS", 0))
# Background grow-ahead: when a write leaves occupancy above this
# fraction of capacity, the engine grows (and warms the new shape's
# kernels) on a daemon thread so the NEXT bucket crossing never happens
# inside a user write txn. 0 disables.
GROW_AHEAD_FRAC = float(os.environ.get("SEMADB_GROW_AHEAD_FRAC", 0.8))


def next_capacity(current: int, max_id: int, row_bytes: int) -> int:
    """Smallest capacity > ``max_id`` under the floor-then-×factor
    policy. Returns ``current`` unchanged when it already fits."""
    if max_id < current:
        return current
    row_bytes = max(row_bytes, 1)
    floor = min(GROW_MIN_ROWS, GROW_MIN_BYTES // row_bytes)
    cap = max(current, 128)
    while cap < floor:
        cap *= 2
    while cap <= max_id:
        cap *= 2 if cap * row_bytes >= GROW_BIG_BYTES else GROW_FACTOR
    return cap


def initial_capacity(row_bytes: int, default: int = 128) -> int:
    """Engine construction capacity: ``default`` (tiny — an empty
    collection costs nothing) unless SEMADB_PREGROW_ROWS asks for a
    pre-grown start. Pre-grow rounds up to a 4096 multiple — one
    deliberate shape, not a growth-bucket overshoot (×4 over-allocation
    at 10M × 128d would waste 15 GB of HBM)."""
    if PREGROW_ROWS <= 0:
        return default
    return max(default, -(-PREGROW_ROWS // 4096) * 4096)
