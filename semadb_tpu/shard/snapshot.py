"""Chunked, incremental device-state snapshots.

Layout per index bucket (replaces the single ``_deviceState`` blob):

  ``_dsMeta``                      msgpack: { "v": 1,
                                     "arrays": {path: {dtype, shape, chunk}},
                                     "small":  {path: packed small values} }
  ``_dsChunk/<path>/<8B BE idx>``  raw bytes of rows [idx*chunk, ...)

Arrays are flattened to "/"-joined paths (IndexVamana's nested ``store``
dict becomes ``store/codes`` etc.), chunked along axis 0 into ~4 MiB
pieces, and written ONLY when dirty — engines track the rows their write
paths scatter (utils/dirty.DirtyTracker) and a flush reads back just
those chunks from the device. This matches bbolt's O(delta)-pages-per-txn
durability cost (diskstore/diskstore.go:45-95, bbolt B+tree) instead of
re-serialising the whole index: at 10M points a full snapshot is ~10 GB
of device→host readback (a long stall); a
typical incremental flush is a few dozen chunks.

Invariants:
  - the store write txn is atomic (overlay rollback), so a crashed flush
    leaves the PREVIOUS meta + chunks + journal intact;
  - shape/dtype/chunk changes force a full rewrite of that array and
    delete stale chunk keys;
  - an engine without a tracker (or whose tracker says "everything")
    gets a full chunked snapshot — never wrong, only slower.

Reference contract being matched: per-txn O(delta) durability of
diskstore.go:45-95; the full-blob path this replaces is kept readable
for old shard files (``_deviceState``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import msgpack
import numpy as np

from semadb_tpu.utils.dirty import ALL

_CLEAN = object()  # sentinel: array has no marks at all

DS_META_KEY = b"_dsMeta"
DS_CHUNK_PREFIX = b"_dsChunk/"
LEGACY_STATE_KEY = b"_deviceState"
CHUNK_TARGET_BYTES = 1 << 22  # ~4 MiB per chunk
SMALL_MAX_BYTES = 1 << 16  # arrays up to 64 KiB ride in the meta blob

SEP = "/"


def _flatten(d: dict, prefix: str = "", out: Optional[dict] = None) -> dict:
    out = {} if out is None else out
    for k, v in d.items():
        assert SEP not in str(k), f"array name may not contain '{SEP}': {k}"
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, path + SEP, out)
        else:
            out[path] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        parts = path.split(SEP)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _chunk_rows(shape: tuple, dtype: np.dtype) -> int:
    row_bytes = int(np.dtype(dtype).itemsize) * int(np.prod(shape[1:], dtype=np.int64))
    return max(1, CHUNK_TARGET_BYTES // max(row_bytes, 1))


def _n_chunks(n_rows: int, chunk: int) -> int:
    return max(1, -(-n_rows // chunk)) if n_rows else 0


def _chunk_key(path: str, idx: int) -> bytes:
    return DS_CHUNK_PREFIX + path.encode() + b"/" + int(idx).to_bytes(8, "big")


def _is_arraylike(v) -> bool:
    return hasattr(v, "shape") and hasattr(v, "dtype")


def _pack_small(small: dict) -> dict:
    def enc(v):
        if _is_arraylike(v):
            a = np.asarray(v)
            return {
                b"__nd": True, b"dtype": str(a.dtype),
                b"shape": list(a.shape), b"data": a.tobytes(),
            }
        return v

    return {k: enc(v) for k, v in small.items()}


def _unpack_small(small: dict) -> dict:
    def dec(v):
        if isinstance(v, dict) and (v.get(b"__nd") or v.get("__nd")):
            dtype = v.get(b"dtype", v.get("dtype"))
            shape = v.get(b"shape", v.get("shape"))
            data = v.get(b"data", v.get("data"))
            return np.frombuffer(data, np.dtype(dtype)).reshape(shape).copy()
        return v

    return {k: dec(v) for k, v in small.items()}


def _device_arrays(idx) -> dict:
    """Flattened {path: array} WITHOUT forcing device→host readback: uses
    the engine's ``device_arrays`` when it has one (raw jax arrays), else
    its ``to_arrays`` (already-materialised numpy)."""
    getter = getattr(idx, "device_arrays", None)
    return _flatten(getter() if getter is not None else idx.to_arrays())


def _fetch_chunks(arr, chunks: np.ndarray, chunk: int, n_rows: int) -> list:
    """Read back the given chunk indices of ``arr`` (device or host) with
    ONE device gather + readback (per-chunk slicing costs a host↔device
    roundtrip each)."""
    if len(chunks) == 0:
        return []
    if isinstance(arr, np.ndarray):
        return [
            np.ascontiguousarray(arr[c * chunk : min((c + 1) * chunk, n_rows)])
            for c in chunks
        ]
    n_chunks_total = _n_chunks(n_rows, chunk)
    # Past half the grid, a plain readback beats a gather — blocked into
    # ≤256 MiB contiguous slices so (a) the device-side slice transient
    # stays bounded (a full-array gather result next to multi-GB slab
    # arrays OOMed the post-replay close compaction) and (b) only rows
    # below the snapshot bound leave the device (the capacity-padded tail
    # of a 16M-row vectors matrix is 3 GB of zeros at 10M).
    row_bytes = int(np.dtype(arr.dtype).itemsize) * int(
        np.prod(arr.shape[1:], dtype=np.int64)
    )
    if len(chunks) * 2 >= n_chunks_total:
        blk_rows = max(1, (1 << 28) // max(row_bytes, 1))
        host = np.empty((n_rows,) + tuple(arr.shape[1:]), np.dtype(arr.dtype))
        for lo in range(0, n_rows, blk_rows):
            hi = min(lo + blk_rows, n_rows)
            host[lo:hi] = np.asarray(arr[lo:hi])
        return [
            host[c * chunk : min((c + 1) * chunk, n_rows)] for c in chunks
        ]
    import jax.numpy as jnp

    rows = np.concatenate(
        [np.arange(c * chunk, min((c + 1) * chunk, n_rows)) for c in chunks]
    )
    # Bound the gather transient: batch so each device-side result stays
    # under ~256 MiB regardless of how many chunks are dirty.
    batch_rows = max(1, (1 << 28) // max(row_bytes, 1))
    parts = [
        np.asarray(arr[jnp.asarray(rows[lo : lo + batch_rows], jnp.int32)])
        for lo in range(0, len(rows), batch_rows)
    ]
    gathered = parts[0] if len(parts) == 1 else np.concatenate(parts)
    out, off = [], 0
    for c in chunks:
        ln = min((c + 1) * chunk, n_rows) - c * chunk
        out.append(gathered[off : off + ln])
        off += ln
    return out


def write_snapshot(bucket, idx) -> int:
    """Persist ``idx``'s device state into ``bucket`` incrementally.

    Must run inside a store write txn. Returns the number of chunk
    records written (diagnostics / tests). Drains the engine's dirty
    tracker; the caller must re-mark ``everything()`` if the surrounding
    txn later fails (the overlay rollback discards our puts).
    """
    lock = getattr(idx, "_write_lock", None) or contextlib.nullcontext()
    with lock:
        # Deferred-fit placeholders hold no device state — materialise
        # them first or the snapshot silently drops those points
        # (IndexIVF._to_arrays_locked does the same).
        if getattr(idx, "_has_placeholders", None) and idx._has_placeholders():
            idx.flush_pending()
        arrays = _device_arrays(idx)
        tracker = getattr(idx, "dirty", None)
        if tracker is not None:
            everything, marks = tracker.collect()
            tracker.clear()
        else:
            everything, marks = True, {}

        # Row bounds: engines whose big arrays are capacity-padded report
        # the USED row count per path — chunks past it are never written
        # (or read back). At 10M the vectors matrix alone saves the whole
        # zero-padded tail (16M-capacity rows for a 10M corpus).
        bounds_fn = getattr(idx, "snapshot_row_bounds", None)
        bounds = bounds_fn() if bounds_fn is not None else {}

        raw_meta = bucket.get(DS_META_KEY)
        prev = (
            msgpack.unpackb(raw_meta, raw=False, strict_map_key=False)
            if raw_meta is not None
            else {"arrays": {}, "small": {}}
        )
        prev_arrays = prev.get("arrays", {})

        meta_arrays: Dict[str, dict] = {}
        small: Dict[str, object] = {}
        written = 0
        for path, arr in arrays.items():
            if not _is_arraylike(arr) or len(getattr(arr, "shape", ())) == 0:
                small[path] = arr
                continue
            shape = tuple(int(s) for s in arr.shape)
            n_rows = max(0, min(int(bounds.get(path, shape[0])), shape[0]))
            nbytes = int(np.dtype(arr.dtype).itemsize) * int(
                np.prod((n_rows,) + shape[1:], dtype=np.int64)
            )
            if nbytes <= SMALL_MAX_BYTES:
                small[path] = np.asarray(arr[:n_rows] if n_rows < shape[0] else arr)
                continue
            dtype = str(np.dtype(arr.dtype))
            chunk = _chunk_rows(shape, arr.dtype)
            meta_arrays[path] = {
                "dtype": dtype, "shape": [n_rows, *shape[1:]], "chunk": chunk,
            }
            p = prev_arrays.get(path)
            prev_rows = int(p.get("shape", [0])[0]) if p is not None else 0
            layout_ok = (
                p is not None
                and p.get("dtype") == dtype
                and list(p.get("shape", []))[1:] == list(shape[1:])
                and p.get("chunk") == chunk
                and prev_rows <= n_rows  # row growth is compatible
            )
            n_total = _n_chunks(n_rows, chunk)
            mark = marks.get(path, _CLEAN)
            if everything or not layout_ok or mark is ALL:
                dirty = np.arange(n_total)
            elif mark is _CLEAN:
                dirty = np.empty(0, np.int64)  # clean array: keep chunks
            else:
                rows = mark[(mark >= 0) & (mark < n_rows)]
                dirty = np.unique(rows // chunk)
            if layout_ok and prev_rows < n_rows:
                # The previous LAST chunk may have been partial; rewrite it
                # (and everything after) so record lengths match the grid.
                first_new = max(0, _n_chunks(prev_rows, chunk) - 1)
                dirty = np.union1d(dirty, np.arange(first_new, n_total))
            for blk, c in zip(
                _fetch_chunks(arr, dirty, chunk, n_rows), dirty
            ):
                bucket.put(_chunk_key(path, int(c)), blk.tobytes())
                written += 1
            # Stale chunks past the new grid (shape shrink or layout
            # change with fewer chunks)
            if p is not None:
                prev_total = _n_chunks(prev_rows, int(p.get("chunk", 1)))
                for c in range(n_total, prev_total):
                    bucket.delete(_chunk_key(path, c))
        # Arrays that vanished since the last snapshot (or moved to small)
        for path, p in prev_arrays.items():
            if path in meta_arrays:
                continue
            prev_total = _n_chunks(
                int(p.get("shape", [0])[0]), int(p.get("chunk", 1))
            )
            for c in range(prev_total):
                bucket.delete(_chunk_key(path, c))
        bucket.put(
            DS_META_KEY,
            msgpack.packb(
                {"v": 1, "arrays": meta_arrays, "small": _pack_small(small)},
                use_bin_type=True,
            ),
        )
        bucket.delete(LEGACY_STATE_KEY)
        return written


def read_snapshot(bucket) -> Optional[dict]:
    """Reconstruct the nested array dict from a chunked snapshot, or None
    when the bucket holds no ``_dsMeta`` (caller falls back to the legacy
    ``_deviceState`` blob)."""
    raw_meta = bucket.get(DS_META_KEY)
    if raw_meta is None:
        return None
    meta = msgpack.unpackb(raw_meta, raw=False, strict_map_key=False)
    flat: dict = dict(_unpack_small(meta.get("small", {})))
    for path, p in meta.get("arrays", {}).items():
        shape = tuple(int(s) for s in p["shape"])
        dtype = np.dtype(p["dtype"])
        chunk = int(p["chunk"])
        arr = np.empty(shape, dtype)
        for c in range(_n_chunks(shape[0], chunk)):
            raw = bucket.get(_chunk_key(path, c))
            if raw is None:
                raise ValueError(
                    f"snapshot corrupt: missing chunk {c} of {path}"
                )
            lo = c * chunk
            hi = min(lo + chunk, shape[0])
            arr[lo:hi] = np.frombuffer(raw, dtype).reshape((hi - lo,) + shape[1:])
        flat[path] = arr
    return _unflatten(flat)
