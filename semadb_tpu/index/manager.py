"""Index manager: schema-driven dispatch of point changes + query execution.

Parity reference: shard/index/manager.go, dispatch.go, search.go, utils.go.

Dispatch (dispatch.go:33-110): for every schema property, diff the old/new
msgpack documents to classify insert/update/delete/skip (utils.go:38-69),
then route the change batch to that property's index. Bucket naming parity:
``index/<type>/<property>``.

Search (search.go:21-298): recursive query-tree execution. ``_and``/``_or``
combine child result sets (intersection/union) and sum hybrid scores of
duplicated results; ``_id`` resolves UUIDs directly; vector queries compute
their filter subquery first and hand the allowed-id set to the index.

Device indices (vamana/flat) live across transactions in a host-side
registry — the analog of the reference's shared cache manager
(cache/manager.go) holding hot indices between bbolt transactions.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from semadb_tpu.index.flat import IndexFlat
from semadb_tpu.index.fused import FusedHybridIVF
from semadb_tpu.index.inverted import IndexInverted, IndexInvertedArray
from semadb_tpu.index.ivf import IndexIVF
from semadb_tpu.index.text import IndexText
from semadb_tpu.index.vamana import IndexVamana
from semadb_tpu.models import constants as C
from semadb_tpu.models.errors import NotFoundError, ValidationError
from semadb_tpu.models.point import SearchResult, access_nested, decode_point_data
from semadb_tpu.models.query import Query
from semadb_tpu.models.schema import IndexSchema
from semadb_tpu.shard import pointstore
from semadb_tpu.store.diskstore import BucketManager

OP_INSERT = "insert"
OP_UPDATE = "update"
OP_DELETE = "delete"
OP_SKIP = "skip"


def _filters_equal(a, b) -> bool:
    """Structural equality of two optional filter Query trees, tolerant of
    ndarray vector fields (packed wire vectors decode to numpy arrays,
    whose ``==`` is elementwise): an ambiguous comparison just means the
    batch falls back to the per-query path — correct, only slower."""
    if a is None or b is None:
        return a is b
    try:
        return bool(a == b)
    except ValueError:
        return False


def get_operation(prop: str, prev_data: Optional[bytes], new_data: Optional[bytes]):
    """(prev_value, new_value, op) for one property (utils.go:38-69)."""
    prev = access_nested(decode_point_data(prev_data), prop) if prev_data else None
    cur = access_nested(decode_point_data(new_data), prop) if new_data else None
    if prev is None and cur is not None:
        return prev, cur, OP_INSERT
    if prev is not None and cur is not None:
        return prev, cur, OP_UPDATE
    if prev is not None and cur is None:
        return prev, cur, OP_DELETE
    return prev, cur, OP_SKIP


class IndexPointChange:
    __slots__ = ("node_id", "previous_data", "new_data")

    def __init__(self, node_id: int, previous_data: Optional[bytes], new_data: Optional[bytes]):
        self.node_id = node_id
        self.previous_data = previous_data
        self.new_data = new_data


class IndexManager:
    def __init__(
        self,
        bm: BucketManager,
        schema: IndexSchema,
        device_registry: Dict[str, object],
        host_caches: Optional[Dict[str, object]] = None,
    ):
        self.bm = bm
        self.schema = schema
        self.devices = device_registry  # bucket_name → IndexVamana | IndexFlat
        # bucket_name → PostingsCache: cross-txn decoded postings owned by
        # the Shard (cache/manager.go:116-303 shared-cache parity) —
        # IndexManager instances are per-txn, the caches are not.
        self.host_caches = host_caches

    def _postings_cache(self, bucket_name: str):
        if self.host_caches is None:
            return None
        cache = self.host_caches.get(bucket_name)
        if cache is None:
            from semadb_tpu.index.inverted import PostingsCache

            cache = self.host_caches[bucket_name] = PostingsCache()
        return cache

    def _text_cache(self, bucket_name: str, bucket):
        if self.host_caches is None:
            return None
        cache = self.host_caches.get(bucket_name)
        if cache is None:
            from semadb_tpu.index.text import (
                TextCaches,
                _doc_codec,
                _postings_codec,
            )
            from semadb_tpu.utils.itemcache import ItemCache

            cache = self.host_caches[bucket_name] = TextCaches(
                postings=ItemCache(bucket, _postings_codec()),
                docs=ItemCache(bucket, _doc_codec()),
            )
        return cache

    # -- index accessors ---------------------------------------------------
    @staticmethod
    def bucket_name(itype: str, prop: str) -> str:
        return f"index/{itype}/{prop}"

    def _device_index(self, itype: str, prop: str, params, register: bool = False):
        name = self.bucket_name(itype, prop)
        idx = self.devices.get(name)
        if idx is None:
            if itype == C.INDEX_TYPE_VECTOR_VAMANA:
                idx = IndexVamana(params)
            elif itype == C.INDEX_TYPE_VECTOR_IVF:
                idx = IndexIVF(params)
            elif itype == C.INDEX_TYPE_VECTOR_FUSED:
                idx = FusedHybridIVF.from_params(params)
            else:
                idx = IndexFlat(params)
            # Only the write path registers new indices: a search racing a
            # scrap-and-reload must not shadow the reloaded index with an
            # empty one (scrap semantics, cache/manager.go:207-235).
            if register:
                self.devices[name] = idx
        return idx

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, changes: List[IndexPointChange]) -> Dict[str, list]:
        """Route changes to per-property indices. Returns the device-index
        deltas applied ({bucket_name: [(node_id, vector|None), ...]}) so the
        caller can journal them in the same store txn (per-txn durability
        for HBM-resident state — the role bbolt's implicit persistence
        played for the reference's graph buckets)."""
        per_property: Dict[str, List[Tuple[int, object, object, str]]] = {}
        for ch in changes:
            for prop, params in self.schema.items():
                prev, cur, op = get_operation(prop, ch.previous_data, ch.new_data)
                if op == OP_SKIP:
                    continue
                per_property.setdefault(prop, []).append((ch.node_id, prev, cur, op))

        device_deltas: Dict[str, list] = {}
        for prop, items in per_property.items():
            params = self.schema.get(prop)
            itype = params.type
            if itype in (
                C.INDEX_TYPE_VECTOR_VAMANA,
                C.INDEX_TYPE_VECTOR_FLAT,
                C.INDEX_TYPE_VECTOR_IVF,
                C.INDEX_TYPE_VECTOR_FUSED,
            ):
                vparams = {
                    C.INDEX_TYPE_VECTOR_VAMANA: params.vector_vamana,
                    C.INDEX_TYPE_VECTOR_FLAT: params.vector_flat,
                    C.INDEX_TYPE_VECTOR_IVF: params.vector_ivf,
                    C.INDEX_TYPE_VECTOR_FUSED: params.vector_fused,
                }[itype]
                idx = self._device_index(itype, prop, vparams, register=True)
                if itype == C.INDEX_TYPE_VECTOR_FUSED:
                    # Wire format: views concatenated into one flat f32 row
                    # (journal-compatible; fused.py _split_flat)
                    delta = [
                        (
                            nid,
                            np.concatenate(
                                [np.asarray(v, np.float32).reshape(-1) for v in cur]
                            )
                            if op != OP_DELETE
                            else None,
                        )
                        for nid, _, cur, op in items
                    ]
                else:
                    delta = [
                        (nid, np.asarray(cur, np.float32) if op != OP_DELETE else None)
                        for nid, _, cur, op in items
                    ]
                idx.insert_update_delete(delta)
                device_deltas[self.bucket_name(itype, prop)] = delta
            elif itype == C.INDEX_TYPE_TEXT:
                bname = self.bucket_name(itype, prop)
                tb = self.bm.get(bname)
                t = IndexText(
                    tb, params.text.analyser,
                    cache=self._text_cache(bname, tb),
                )
                for nid, prev, cur, op in items:
                    if op == OP_INSERT:
                        t.insert(nid, cur)
                    elif op == OP_UPDATE:
                        t.update(nid, cur)
                    else:
                        t.delete(nid)
                t.flush()  # write-back postings persist once per batch
            elif itype in (C.INDEX_TYPE_STRING, C.INDEX_TYPE_INTEGER, C.INDEX_TYPE_FLOAT):
                kind = {
                    C.INDEX_TYPE_STRING: "string",
                    C.INDEX_TYPE_INTEGER: "integer",
                    C.INDEX_TYPE_FLOAT: "float",
                }[itype]
                case_sensitive = (
                    params.string.case_sensitive if itype == C.INDEX_TYPE_STRING and params.string else True
                )
                bname = self.bucket_name(itype, prop)
                inv = IndexInverted(
                    self.bm.get(bname), kind, case_sensitive,
                    cache=self._postings_cache(bname),
                )
                for nid, prev, cur, op in items:
                    if op == OP_INSERT:
                        inv.insert(nid, cur)
                    elif op == OP_UPDATE:
                        inv.update(nid, prev, cur)
                    else:
                        inv.delete(nid, prev)
                inv.flush()  # cached mutations persist once per batch
            elif itype == C.INDEX_TYPE_STRING_ARRAY:
                case_sensitive = params.string_array.case_sensitive if params.string_array else False
                bname = self.bucket_name(itype, prop)
                arr = IndexInvertedArray(
                    self.bm.get(bname), case_sensitive,
                    cache=self._postings_cache(bname),
                )
                for nid, prev, cur, op in items:
                    if op == OP_INSERT:
                        arr.insert(nid, cur)
                    elif op == OP_UPDATE:
                        arr.update(nid, prev, cur)
                    else:
                        arr.delete(nid, prev)
                arr.flush()
            else:
                raise ValidationError(f"unknown index type {itype}")
        return device_deltas

    # -- search ------------------------------------------------------------
    def search(self, q: Query) -> Tuple[Set[int], List[SearchResult]]:
        if q.property == "_and":
            return self._search_combined(q.and_, disjunction=False)
        if q.property == "_or":
            return self._search_combined(q.or_, disjunction=True)
        if q.property == "_id":
            return self._search_by_id(q)

        params = self.schema.get(q.property)
        if params is None:
            raise ValidationError(f"property {q.property} not found in index schema")
        itype = params.type

        if itype == C.INDEX_TYPE_VECTOR_VAMANA:
            opts = q.vector_vamana
            filter_set = None
            if opts.filter is not None:
                filter_set, _ = self.search(opts.filter)
            idx = self._device_index(itype, q.property, params.vector_vamana)
            return self._vector_search(
                idx, opts.vector, opts.limit, opts.weight,
                search_size=opts.search_size, filter_set=filter_set,
            )
        if itype == C.INDEX_TYPE_VECTOR_FLAT:
            opts = q.vector_flat
            filter_set = None
            if opts.filter is not None:
                filter_set, _ = self.search(opts.filter)
            idx = self._device_index(itype, q.property, params.vector_flat)
            return self._vector_search(
                idx, opts.vector, opts.limit, opts.weight, filter_set=filter_set
            )
        if itype == C.INDEX_TYPE_VECTOR_IVF:
            opts = q.vector_ivf
            filter_set = None
            if opts.filter is not None:
                filter_set, _ = self.search(opts.filter)
            idx = self._device_index(itype, q.property, params.vector_ivf)
            return self._vector_search(
                idx, opts.vector, opts.limit, opts.weight,
                num_probes=opts.num_probes, filter_set=filter_set,
            )
        if itype == C.INDEX_TYPE_VECTOR_FUSED:
            opts = q.vector_fused
            filter_set = None
            if opts.filter is not None:
                filter_set, _ = self.search(opts.filter)
            idx = self._device_index(itype, q.property, params.vector_fused)
            filter_mask = None
            if filter_set is not None:
                cap = idx.capacity
                filter_mask = np.zeros(cap, bool)
                filter_mask[[i for i in filter_set if i < cap]] = True
            qviews = [np.asarray(v, np.float32)[None, :] for v in opts.vectors]
            d, i = idx.search_batch(
                qviews, opts.limit, weights=opts.weights,
                num_probes=opts.num_probes, filter_mask=filter_mask,
            )
            w = opts.weight if opts.weight is not None else 1.0
            rset: Set[int] = set()
            results: List[SearchResult] = []
            for dist, nid in zip(d[0], i[0]):
                if nid < 0 or not np.isfinite(dist):
                    continue
                rset.add(int(nid))
                results.append(
                    SearchResult(
                        point=None,
                        node_id=int(nid),
                        distance=float(dist),
                        hybrid_score=-float(dist) * w,
                    )
                )
            return rset, results
        if itype == C.INDEX_TYPE_TEXT:
            filter_set = None
            if q.text.filter is not None:
                filter_set, _ = self.search(q.text.filter)
            bname = self.bucket_name(itype, q.property)
            tb = self.bm.get(bname)
            t = IndexText(
                tb, params.text.analyser, cache=self._text_cache(bname, tb)
            )
            return t.search(q.text, filter_set)
        if itype in (C.INDEX_TYPE_STRING, C.INDEX_TYPE_INTEGER, C.INDEX_TYPE_FLOAT):
            kind = {
                C.INDEX_TYPE_STRING: "string",
                C.INDEX_TYPE_INTEGER: "integer",
                C.INDEX_TYPE_FLOAT: "float",
            }[itype]
            case_sensitive = (
                params.string.case_sensitive if itype == C.INDEX_TYPE_STRING and params.string else True
            )
            bname = self.bucket_name(itype, q.property)
            inv = IndexInverted(
                self.bm.get(bname), kind, case_sensitive,
                cache=self._postings_cache(bname),
            )
            o = {"string": q.string, "integer": q.integer, "float": q.float_}[kind]
            return inv.search(o.value, o.end_value, o.operator), []
        if itype == C.INDEX_TYPE_STRING_ARRAY:
            case_sensitive = params.string_array.case_sensitive if params.string_array else False
            bname = self.bucket_name(itype, q.property)
            arr = IndexInvertedArray(
                self.bm.get(bname), case_sensitive,
                cache=self._postings_cache(bname),
            )
            return arr.search(q.string_array.value, q.string_array.operator), []
        raise ValidationError(f"search not supported for type {itype}")

    def search_batch(
        self, queries: List[Query]
    ) -> List[Tuple[Set[int], List[SearchResult]]]:
        """Batched search: ONE device dispatch for a homogeneous query
        list, per-query fallback otherwise.

        Beyond-reference serving shape: the reference executes one query
        per request end to end (shard.go:323-380); on an accelerator a
        per-query dispatch is roundtrip-bound while a stacked [B, D]
        batch rides the same matmul as one query. Homogeneous = same
        property and index type, equal options apart from the query
        vector(s), and structurally equal filters (the filter subquery is
        computed once and shared)."""
        if len(queries) == 1:
            return [self.search(queries[0])]
        arrs = self.search_batch_arrays(queries)
        if arrs is None:
            return [self.search(q) for q in queries]
        d_host, i_host, valid, w = arrs
        # One bulk device→host conversion + tolist(): iterating numpy rows
        # boxes every element into a np scalar (~5× the cost of a Python
        # float loop), measurable at 10k results per 1024-query batch on
        # the 1-vCPU serving host.
        d_list = d_host.tolist()
        i_list = i_host.tolist()
        v_list = valid.tolist()
        out: List[Tuple[Set[int], List[SearchResult]]] = []
        for b in range(len(queries)):
            results: List[SearchResult] = [
                SearchResult(
                    point=None, node_id=nid,
                    distance=dist, hybrid_score=-dist * w,
                )
                for dist, nid, ok in zip(d_list[b], i_list[b], v_list[b])
                if ok
            ]
            out.append(({r.node_id for r in results}, results))
        return out

    def search_batch_arrays(self, queries: List[Query]):
        """Array core of :meth:`search_batch`: ``(d f32[B,K], i i32[B,K],
        valid bool[B,K], weight)`` host arrays for a homogeneous vector
        batch, or None when no batch plan applies. The id-only serving
        fast path (Shard.search_points_batch_wire) consumes the arrays
        directly — no per-result SearchResult/Point objects."""
        plan = self._batch_plan(queries)
        if plan is None:
            return None
        itype, prop, params, opts_list = plan
        o0 = opts_list[0]
        filter_set = None
        if o0.filter is not None:
            filter_set, _ = self.search(o0.filter)
        if itype == C.INDEX_TYPE_VECTOR_FUSED:
            idx = self._device_index(itype, prop, params.vector_fused)
            filter_mask = None
            if filter_set is not None:
                filter_mask = np.zeros(idx.capacity, bool)
                filter_mask[[i for i in filter_set if i < idx.capacity]] = True
            qviews = [
                np.stack([np.asarray(o.vectors[v], np.float32) for o in opts_list])
                for v in range(len(o0.vectors))
            ]
            d, i = idx.search_batch(
                qviews, o0.limit, weights=o0.weights,
                num_probes=o0.num_probes, filter_mask=filter_mask,
            )
        else:
            pp = {
                C.INDEX_TYPE_VECTOR_VAMANA: params.vector_vamana,
                C.INDEX_TYPE_VECTOR_FLAT: params.vector_flat,
                C.INDEX_TYPE_VECTOR_IVF: params.vector_ivf,
            }[itype]
            idx = self._device_index(itype, prop, pp)
            vecs = np.stack([np.asarray(o.vector, np.float32) for o in opts_list])
            filter_mask = None
            if filter_set is not None:
                cap = idx.state.capacity if hasattr(idx, "state") else idx.capacity
                filter_mask = np.zeros(cap, bool)
                filter_mask[[i for i in filter_set if i < cap]] = True
            if itype == C.INDEX_TYPE_VECTOR_VAMANA:
                d, i = idx.search_batch(
                    vecs, k=o0.limit, search_size=o0.search_size,
                    filter_mask=filter_mask,
                )
            elif itype == C.INDEX_TYPE_VECTOR_IVF:
                d, i = idx.search_batch(
                    vecs, k=o0.limit, num_probes=o0.num_probes,
                    filter_mask=filter_mask,
                )
            else:
                d, i = idx.search_batch(vecs, k=o0.limit, filter_mask=filter_mask)
        d_host = np.asarray(d)
        i_host = np.asarray(i)
        valid = (i_host >= 0) & np.isfinite(d_host)
        w = o0.weight if o0.weight is not None else 1.0
        return d_host, i_host, valid, w

    def _batch_plan(self, queries: List[Query]):
        """(itype, property, params, [opts]) when every query hits the same
        vector index with equal non-vector options; None otherwise."""
        q0 = queries[0]
        if q0.property in ("_and", "_or", "_id"):
            return None
        params = self.schema.get(q0.property)
        if params is None:
            return None
        itype = params.type
        getter = {
            C.INDEX_TYPE_VECTOR_VAMANA: lambda q: q.vector_vamana,
            C.INDEX_TYPE_VECTOR_FLAT: lambda q: q.vector_flat,
            C.INDEX_TYPE_VECTOR_IVF: lambda q: q.vector_ivf,
            C.INDEX_TYPE_VECTOR_FUSED: lambda q: q.vector_fused,
        }.get(itype)
        if getter is None:
            return None
        opts_list = []
        o0 = getter(q0)
        for q in queries:
            if q.property != q0.property:
                return None
            o = getter(q)
            if o is None:
                return None
            same = (
                o.limit == o0.limit
                and o.weight == o0.weight
                and _filters_equal(o.filter, o0.filter)
                and getattr(o, "search_size", 0) == getattr(o0, "search_size", 0)
                and getattr(o, "num_probes", 0) == getattr(o0, "num_probes", 0)
                and getattr(o, "weights", None) == getattr(o0, "weights", None)
                and len(getattr(o, "vectors", ()) or ())
                == len(getattr(o0, "vectors", ()) or ())
            )
            if not same:
                return None
            opts_list.append(o)
        return itype, q0.property, params, opts_list

    def _vector_search(
        self, idx, vector, limit, weight, search_size=0, num_probes=0, filter_set=None
    ):
        """Shared vamana/flat/ivf search: hybrid score = -distance * weight
        (vamana.go Search:...; flat.go equivalent)."""
        q = np.asarray(vector, np.float32)[None, :]
        filter_mask = None
        if filter_set is not None:
            cap = idx.state.capacity if hasattr(idx, "state") else idx.capacity
            filter_mask = np.zeros(cap, bool)
            ids_in = [i for i in filter_set if i < cap]
            filter_mask[ids_in] = True
        if isinstance(idx, IndexVamana):
            d, i = idx.search_batch(q, k=limit, search_size=search_size, filter_mask=filter_mask)
        elif isinstance(idx, IndexIVF):
            d, i = idx.search_batch(q, k=limit, num_probes=num_probes, filter_mask=filter_mask)
        else:
            d, i = idx.search_batch(q, k=limit, filter_mask=filter_mask)
        w = weight if weight is not None else 1.0
        rset: Set[int] = set()
        results: List[SearchResult] = []
        for dist, nid in zip(d[0], i[0]):
            if nid < 0 or not np.isfinite(dist):
                continue
            rset.add(int(nid))
            results.append(
                SearchResult(
                    point=None,
                    node_id=int(nid),
                    distance=float(dist),
                    hybrid_score=-float(dist) * w,
                )
            )
        return rset, results

    def _search_by_id(self, q: Query) -> Tuple[Set[int], List[SearchResult]]:
        """searchById (search.go:171-209): direct UUID → node id lookup."""
        bucket = self.bm.get(pointstore.POINTS_BUCKET_NAME)
        if q.string is not None:
            if q.string.operator != C.OPERATOR_EQUALS:
                raise ValidationError(f"only equals operator supported for _id")
            ids = [q.string.value]
        elif q.string_array is not None:
            if q.string_array.operator != C.OPERATOR_CONTAINS_ANY:
                raise ValidationError("only containsAny operator supported for _id")
            ids = q.string_array.value
        else:
            raise ValidationError("only string/stringArray queries supported for _id")
        rset: Set[int] = set()
        for v in ids:
            try:
                uid = uuid_mod.UUID(v)
            except ValueError:
                continue  # malformed UUID = no match (search.go:185-189)
            try:
                rset.add(pointstore.get_point_node_id_by_uuid(bucket, uid))
            except NotFoundError:
                continue  # missing points silently skipped (search.go:204)
        return rset, []

    def _search_combined(self, queries: List[Query], disjunction: bool):
        """searchParallel (search.go:211-298): execute children in parallel
        threads, AND/OR the sets, dedup results summing hybrid scores.

        Thread fan-out mirrors the reference's goroutine-per-child. Device
        searches release the GIL during XLA compute and host-side bucket
        reads are read-only within this transaction, so children genuinely
        overlap; results are merged in query order (deterministic)."""
        if len(queries) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(queries)) as ex:
                outs = list(ex.map(self.search, queries))
        else:
            outs = [self.search(sub) for sub in queries]
        if len(outs) == 1:
            return outs[0]
        sets = [s for s, _ in outs]
        final: Set[int] = set(sets[0])
        for s in sets[1:]:
            final = (final | s) if disjunction else (final & s)
        merged: Dict[int, SearchResult] = {}
        order: List[int] = []
        for _, results in outs:
            for r in results:
                if not disjunction and r.node_id not in final:
                    continue
                if r.node_id not in merged:
                    merged[r.node_id] = r
                    order.append(r.node_id)
                else:
                    m = merged[r.node_id]
                    m.hybrid_score += r.hybrid_score
                    if m.distance is None and r.distance is not None:
                        m.distance = r.distance
                    if m.score is None and r.score is not None:
                        m.score = r.score
        final_results = sorted(
            (merged[n] for n in order), key=lambda r: -r.hybrid_score
        )
        return final, final_results
