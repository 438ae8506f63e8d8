"""Index schema: property → index type + parameters, with point validation.

Parity reference: models/index.go (IndexSchema, IndexSchemaValue, per-type
parameter structs, CheckCompatibleMap with nested-property support and type
coercion).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from semadb_tpu.models import constants as C
from semadb_tpu.models.errors import ValidationError
from semadb_tpu.models.quantizer import Quantizer


def _check_metric(metric: str, vector_size: int) -> None:
    if metric not in C.DISTANCE_METRICS:
        raise ValidationError(f"unknown distance metric {metric}")
    if metric == C.DISTANCE_HAVERSINE and vector_size != 2:
        raise ValidationError(
            f"haversine distance metric requires vector size 2 got {vector_size}"
        )


@dataclass
class VectorFlatParams:
    """Reference: models/index.go IndexVectorFlatParameters."""

    vector_size: int
    distance_metric: str
    quantizer: Optional[Quantizer] = None

    def validate(self) -> None:
        if not (1 <= self.vector_size <= 4096):
            raise ValidationError(
                f"vector size must be between 1 and 4096, got {self.vector_size}"
            )
        _check_metric(self.distance_metric, self.vector_size)
        if self.quantizer is not None:
            self.quantizer.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "VectorFlatParams":
        return cls(
            vector_size=int(d["vectorSize"]),
            distance_metric=d["distanceMetric"],
            quantizer=Quantizer.from_dict(d.get("quantizer")),
        )

    def to_dict(self) -> dict:
        out: dict = {"vectorSize": self.vector_size, "distanceMetric": self.distance_metric}
        if self.quantizer is not None:
            out["quantizer"] = self.quantizer.to_dict()
        return out


@dataclass
class VectorVamanaParams:
    """Reference: models/index.go IndexVectorVamanaParameters.

    Defaults are the reference's v1 pipeline values (httpapi/v1/handlers.go:102-105).
    """

    vector_size: int
    distance_metric: str
    search_size: int = 75
    degree_bound: int = 64
    alpha: float = 1.2
    quantizer: Optional[Quantizer] = None

    def validate(self) -> None:
        if not (1 <= self.vector_size <= 4096):
            raise ValidationError(
                f"vector size must be between 1 and 4096, got {self.vector_size}"
            )
        _check_metric(self.distance_metric, self.vector_size)
        if not (25 <= self.search_size <= 75):
            raise ValidationError(
                f"search size must be between 25 and 75, got {self.search_size}"
            )
        if not (32 <= self.degree_bound <= 64):
            raise ValidationError(
                f"degree bound must be between 32 and 64, got {self.degree_bound}"
            )
        if not (1.1 <= self.alpha <= 1.5):
            raise ValidationError(f"alpha must be between 1.1 and 1.5, got {self.alpha}")
        if self.quantizer is not None:
            self.quantizer.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "VectorVamanaParams":
        return cls(
            vector_size=int(d["vectorSize"]),
            distance_metric=d["distanceMetric"],
            search_size=int(d.get("searchSize", 75)),
            degree_bound=int(d.get("degreeBound", 64)),
            alpha=float(d.get("alpha", 1.2)),
            quantizer=Quantizer.from_dict(d.get("quantizer")),
        )

    def to_dict(self) -> dict:
        out: dict = {
            "vectorSize": self.vector_size,
            "distanceMetric": self.distance_metric,
            "searchSize": self.search_size,
            "degreeBound": self.degree_bound,
            "alpha": self.alpha,
        }
        if self.quantizer is not None:
            out["quantizer"] = self.quantizer.to_dict()
        return out


@dataclass
class VectorIVFParams:
    """IVF (clustered) index parameters — no reference
    counterpart (index/ivf.py rationale). ``numClusters``/``numProbes``
    default to size-derived values (N/24 clusters, C/170 probes);
    ``slabSize`` is the padded per-cluster slot count."""

    vector_size: int
    distance_metric: str
    num_probes: int = 0  # 0 = auto
    num_clusters: int = 0  # 0 = auto (N / 24, capped)
    slab_size: int = 0  # 0 = default (64)
    # SOAR-style spilled assignment: each point is stored in its
    # `assignCopies` nearest clusters (best-effort past the first), so
    # boundary points — the dominant probe-miss mode — are reachable from
    # either side. 2 costs ~2x slab memory for a large recall gain.
    assign_copies: int = 1
    quantizer: Optional[Quantizer] = None
    # Traversal dimension override (0 = engine default of 128). Corpora
    # whose intrinsic dimension exceeds the default (e.g. the fused
    # multi-view augmented space, index/fused.py) set this to the full
    # vector size to trade slab bandwidth for projection-free probing.
    proj_dim: int = 0

    def validate(self) -> None:
        if not (1 <= self.vector_size <= 4096):
            raise ValidationError(
                f"vector size must be between 1 and 4096, got {self.vector_size}"
            )
        if self.proj_dim and not (32 <= self.proj_dim <= 4096):
            raise ValidationError(
                f"projDim must be between 32 and 4096, got {self.proj_dim}"
            )
        if self.distance_metric not in (
            C.DISTANCE_EUCLIDEAN, C.DISTANCE_DOT, C.DISTANCE_COSINE
        ):
            raise ValidationError(
                "vectorIVF supports euclidean/dot/cosine metrics,"
                f" got {self.distance_metric}"
            )
        if self.num_probes and not (1 <= self.num_probes <= 1024):
            raise ValidationError(
                f"numProbes must be between 1 and 1024, got {self.num_probes}"
            )
        if self.num_clusters and not (16 <= self.num_clusters <= 2**18):
            raise ValidationError(
                f"numClusters must be between 16 and 262144, got {self.num_clusters}"
            )
        if self.quantizer is not None and self.quantizer.type not in (
            C.QUANTIZER_NONE, C.QUANTIZER_PRODUCT
        ):
            raise ValidationError(
                "vectorIVF supports only the product quantizer (IVF-PQ),"
                f" got {self.quantizer.type}"
            )
        if self.quantizer is not None:
            self.quantizer.validate()
            if (
                self.quantizer.type == C.QUANTIZER_PRODUCT
                and self.vector_size % self.quantizer.product.num_subvectors != 0
            ):
                raise ValidationError(
                    f"vector size {self.vector_size} not divisible by"
                    f" numSubVectors {self.quantizer.product.num_subvectors}"
                )
        if self.slab_size and not (8 <= self.slab_size <= 1024):
            raise ValidationError(
                f"slabSize must be between 8 and 1024, got {self.slab_size}"
            )
        # Cap 8: copies multiply slab memory ~linearly; 6 measured +0.005
        # recall on product-structured fused corpora
        if not (1 <= self.assign_copies <= 8):
            raise ValidationError(
                f"assignCopies must be between 1 and 8, got {self.assign_copies}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "VectorIVFParams":
        return cls(
            vector_size=int(d["vectorSize"]),
            distance_metric=d["distanceMetric"],
            num_probes=int(d.get("numProbes", 0)),
            num_clusters=int(d.get("numClusters", 0)),
            slab_size=int(d.get("slabSize", 0)),
            assign_copies=int(d.get("assignCopies", 1)),
            quantizer=Quantizer.from_dict(d.get("quantizer")),
            proj_dim=int(d.get("projDim", 0)),
        )

    def to_dict(self) -> dict:
        out: dict = {"vectorSize": self.vector_size, "distanceMetric": self.distance_metric}
        if self.num_probes:
            out["numProbes"] = self.num_probes
        if self.num_clusters:
            out["numClusters"] = self.num_clusters
        if self.slab_size:
            out["slabSize"] = self.slab_size
        if self.assign_copies != 1:
            out["assignCopies"] = self.assign_copies
        if self.quantizer is not None:
            out["quantizer"] = self.quantizer.to_dict()
        if self.proj_dim:
            out["projDim"] = self.proj_dim
        return out


@dataclass
class TextParams:
    """Reference: models/index.go IndexTextParameters."""

    analyser: str = "standard"

    def validate(self) -> None:
        if self.analyser != "standard":
            raise ValidationError(f"unknown analyser {self.analyser}")

    @classmethod
    def from_dict(cls, d: dict) -> "TextParams":
        return cls(analyser=d.get("analyser", "standard"))

    def to_dict(self) -> dict:
        return {"analyser": self.analyser}


@dataclass
class StringParams:
    """Reference: models/index.go IndexStringParameters."""

    case_sensitive: bool = False

    def validate(self) -> None:  # nothing to check (reference parity)
        pass

    @classmethod
    def from_dict(cls, d: dict) -> "StringParams":
        return cls(case_sensitive=bool(d.get("caseSensitive", False)))

    def to_dict(self) -> dict:
        return {"caseSensitive": self.case_sensitive}


@dataclass
class FusedViewParams:
    """One view of a vectorFused property: its embedding space and the
    default fusion weight (overridable per query)."""

    vector_size: int
    distance_metric: str
    weight: float = 1.0

    def validate(self) -> None:
        if not (1 <= self.vector_size <= 4096):
            raise ValidationError(
                f"view vector size must be between 1 and 4096, got {self.vector_size}"
            )
        if self.distance_metric not in (
            C.DISTANCE_EUCLIDEAN, C.DISTANCE_DOT, C.DISTANCE_COSINE
        ):
            raise ValidationError(
                "vectorFused views support euclidean/dot/cosine metrics,"
                f" got {self.distance_metric}"
            )
        if not (0 < self.weight <= 100):
            raise ValidationError(
                f"view weight must be in (0, 100], got {self.weight}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "FusedViewParams":
        return cls(
            vector_size=int(d["vectorSize"]),
            distance_metric=d["distanceMetric"],
            weight=float(d.get("weight", 1.0)),
        )

    def to_dict(self) -> dict:
        return {
            "vectorSize": self.vector_size,
            "distanceMetric": self.distance_metric,
            "weight": self.weight,
        }


@dataclass
class VectorFusedParams:
    """Fused multi-view index parameters — no reference
    counterpart. The weighted combined score over all views is computed
    exactly inside ONE augmented-space search (index/fused.py), so
    hybrid recall does not depend on per-view candidate pools. Point
    values for the property are a list of one vector per view."""

    views: list  # List[FusedViewParams]
    num_probes: int = 0  # 0 = auto
    num_clusters: int = 0  # 0 = auto
    assign_copies: int = 2

    def validate(self) -> None:
        if not (2 <= len(self.views) <= 8):
            raise ValidationError(
                f"vectorFused needs between 2 and 8 views, got {len(self.views)}"
            )
        for v in self.views:
            v.validate()
        if sum(v.vector_size for v in self.views) + len(self.views) > 4096:
            raise ValidationError("total fused vector size exceeds 4096")
        if self.num_probes and not (1 <= self.num_probes <= 1024):
            raise ValidationError(
                f"numProbes must be between 1 and 1024, got {self.num_probes}"
            )
        if self.num_clusters and not (16 <= self.num_clusters <= 2**18):
            raise ValidationError(
                f"numClusters must be between 16 and 262144, got {self.num_clusters}"
            )
        # Cap 8: copies multiply slab memory ~linearly; 6 measured +0.005
        # recall on product-structured fused corpora
        if not (1 <= self.assign_copies <= 8):
            raise ValidationError(
                f"assignCopies must be between 1 and 8, got {self.assign_copies}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "VectorFusedParams":
        return cls(
            views=[FusedViewParams.from_dict(v) for v in d["views"]],
            num_probes=int(d.get("numProbes", 0)),
            num_clusters=int(d.get("numClusters", 0)),
            assign_copies=int(d.get("assignCopies", 2)),
        )

    def to_dict(self) -> dict:
        out: dict = {"views": [v.to_dict() for v in self.views]}
        if self.num_probes:
            out["numProbes"] = self.num_probes
        if self.num_clusters:
            out["numClusters"] = self.num_clusters
        if self.assign_copies != 2:
            out["assignCopies"] = self.assign_copies
        return out


@dataclass
class IndexSchemaValue:
    """One property's index declaration (models/index.go IndexSchemaValue)."""

    type: str
    vector_flat: Optional[VectorFlatParams] = None
    vector_vamana: Optional[VectorVamanaParams] = None
    vector_ivf: Optional["VectorIVFParams"] = None
    vector_fused: Optional["VectorFusedParams"] = None
    text: Optional[TextParams] = None
    string: Optional[StringParams] = None
    string_array: Optional[StringParams] = None

    def validate(self) -> None:
        if self.type not in C.INDEX_TYPES:
            raise ValidationError(f"unknown index type {self.type}")
        required = {
            C.INDEX_TYPE_VECTOR_FLAT: ("vectorFlat", self.vector_flat),
            C.INDEX_TYPE_VECTOR_VAMANA: ("vectorVamana", self.vector_vamana),
            C.INDEX_TYPE_VECTOR_IVF: ("vectorIVF", self.vector_ivf),
            C.INDEX_TYPE_VECTOR_FUSED: ("vectorFused", self.vector_fused),
            C.INDEX_TYPE_TEXT: ("text", self.text),
            C.INDEX_TYPE_STRING: ("string", self.string),
            C.INDEX_TYPE_STRING_ARRAY: ("stringArray", self.string_array),
        }
        if self.type in required:
            name, params = required[self.type]
            if params is None:
                raise ValidationError(f"{name} parameters not provided for type {self.type}")
            params.validate()

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSchemaValue":
        return cls(
            type=d["type"],
            vector_flat=VectorFlatParams.from_dict(d["vectorFlat"]) if d.get("vectorFlat") else None,
            vector_vamana=(
                VectorVamanaParams.from_dict(d["vectorVamana"]) if d.get("vectorVamana") else None
            ),
            vector_ivf=VectorIVFParams.from_dict(d["vectorIVF"]) if d.get("vectorIVF") else None,
            vector_fused=(
                VectorFusedParams.from_dict(d["vectorFused"]) if d.get("vectorFused") else None
            ),
            text=TextParams.from_dict(d["text"]) if d.get("text") else None,
            string=StringParams.from_dict(d["string"]) if d.get("string") else None,
            string_array=StringParams.from_dict(d["stringArray"]) if d.get("stringArray") else None,
        )

    def to_dict(self) -> dict:
        out: dict = {"type": self.type}
        if self.vector_flat is not None:
            out["vectorFlat"] = self.vector_flat.to_dict()
        if self.vector_vamana is not None:
            out["vectorVamana"] = self.vector_vamana.to_dict()
        if self.vector_ivf is not None:
            out["vectorIVF"] = self.vector_ivf.to_dict()
        if self.vector_fused is not None:
            out["vectorFused"] = self.vector_fused.to_dict()
        if self.text is not None:
            out["text"] = self.text.to_dict()
        if self.string is not None:
            out["string"] = self.string.to_dict()
        if self.string_array is not None:
            out["stringArray"] = self.string_array.to_dict()
        return out


def _convert_to_vector(v) -> list:
    """Coerce arbitrary JSON values into a float list (models/index.go:78-106).

    Fast path: one ``np.asarray`` + ``tolist`` instead of a per-element
    Python loop — at 128d the loop costs ~1 ms per point, which alone
    capped HTTP ingest near 1.3k pts/s on the 1-vCPU host (round-4 weak
    finding). Invalid content (bools, strings, nested lists) lands on a
    non-float dtype and falls through to the strict per-element check for
    the precise error message."""
    if isinstance(v, np.ndarray):
        if v.ndim != 1:
            raise ValidationError(f"expected 1-d vector array, got shape {v.shape}")
        return v.astype(np.float64).tolist()
    if isinstance(v, (list, tuple)):
        try:
            arr = np.asarray(v)
        except Exception:
            arr = np.empty(0, object)
        # bools coerce silently into float dtype when mixed with numbers;
        # the contract rejects them (models/index.go:78-106), so scan —
        # an isinstance sweep is still ~20× cheaper than the float() loop
        if (
            arr.ndim == 1
            and arr.dtype.kind in "fiu"
            and not any(isinstance(f, bool) for f in v)
        ):
            return arr.astype(np.float64).tolist()
        out = []
        for f in v:
            if isinstance(f, bool) or not isinstance(f, (int, float, np.floating, np.integer)):
                raise ValidationError(f"expected float, got {type(f).__name__}")
            out.append(float(f))
        return out
    raise ValidationError(f"expected vector array, got {type(v).__name__}")


@dataclass
class IndexSchema:
    """Collection index schema: property name → IndexSchemaValue.

    Supports nested properties with dot notation ``a.b.c``
    (models/index.go CheckCompatibleMap).
    """

    properties: dict = field(default_factory=dict)  # str -> IndexSchemaValue

    def validate(self) -> None:
        for v in self.properties.values():
            v.validate()

    def get(self, prop: str) -> Optional[IndexSchemaValue]:
        return self.properties.get(prop)

    def __contains__(self, prop: str) -> bool:
        return prop in self.properties

    def items(self):
        return self.properties.items()

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSchema":
        return cls(properties={k: IndexSchemaValue.from_dict(v) for k, v in d.items()})

    def to_dict(self) -> dict:
        return {k: v.to_dict() for k, v in self.properties.items()}

    def check_compatible_map(self, point_map: dict) -> None:
        """Validate + coerce a user point map in place.

        Mirrors models/index.go CheckCompatibleMap: absent properties are
        skipped; present properties are type-checked and coerced (vectors to
        float lists, ints to int, floats to float, string arrays to lists of
        str) so downstream index code can rely on types.
        """
        for prop, schema in self.properties.items():
            parts = prop.split(".")
            m = point_map
            skip = False
            for i, part in enumerate(parts[:-1]):
                nxt = m.get(part) if isinstance(m, dict) else None
                if nxt is None:
                    skip = True
                    break
                if not isinstance(nxt, dict):
                    raise ValidationError(
                        f"expected nested map for property {part}, got {type(nxt).__name__}"
                    )
                m = nxt
            if skip or not isinstance(m, dict) or parts[-1] not in m:
                continue
            k = parts[-1]
            v = m[k]
            t = schema.type
            if t in (C.INDEX_TYPE_VECTOR_FLAT, C.INDEX_TYPE_VECTOR_VAMANA, C.INDEX_TYPE_VECTOR_IVF):
                try:
                    vec = _convert_to_vector(v)
                except ValidationError as e:
                    raise ValidationError(f"expected a vector for property {k}: {e}") from e
                params = {
                    C.INDEX_TYPE_VECTOR_FLAT: schema.vector_flat,
                    C.INDEX_TYPE_VECTOR_VAMANA: schema.vector_vamana,
                    C.INDEX_TYPE_VECTOR_IVF: schema.vector_ivf,
                }[t]
                if len(vec) != params.vector_size:
                    raise ValidationError(
                        f"expected vector of size {params.vector_size} for property {k},"
                        f" got {len(vec)}"
                    )
                m[k] = vec
            elif t == C.INDEX_TYPE_VECTOR_FUSED:
                views = schema.vector_fused.views
                if not isinstance(v, (list, tuple)) or len(v) != len(views):
                    raise ValidationError(
                        f"expected {len(views)} view vectors for property {k},"
                        f" got {type(v).__name__}"
                        + (f" of length {len(v)}" if isinstance(v, (list, tuple)) else "")
                    )
                coerced = []
                for vi, (vv, vp) in enumerate(zip(v, views)):
                    try:
                        vec = _convert_to_vector(vv)
                    except ValidationError as e:
                        raise ValidationError(
                            f"expected a vector for view {vi} of property {k}: {e}"
                        ) from e
                    if len(vec) != vp.vector_size:
                        raise ValidationError(
                            f"expected vector of size {vp.vector_size} for view {vi}"
                            f" of property {k}, got {len(vec)}"
                        )
                    coerced.append(vec)
                m[k] = coerced
            elif t in (C.INDEX_TYPE_TEXT, C.INDEX_TYPE_STRING):
                if not isinstance(v, str):
                    raise ValidationError(
                        f"expected string for property {k}, got {type(v).__name__}"
                    )
            elif t == C.INDEX_TYPE_INTEGER:
                if isinstance(v, bool):
                    raise ValidationError(f"expected integer number for property {k}, got bool")
                if isinstance(v, (int, np.integer)):
                    m[k] = int(v)
                elif isinstance(v, (float, np.floating)):
                    # JSON decodes numbers as float; coerce like the reference
                    m[k] = int(v)
                else:
                    raise ValidationError(
                        f"expected integer number for property {k}, got {type(v).__name__}"
                    )
            elif t == C.INDEX_TYPE_FLOAT:
                if isinstance(v, bool) or not isinstance(v, (int, float, np.floating, np.integer)):
                    raise ValidationError(
                        f"expected floating point number for property {k}, got {type(v).__name__}"
                    )
                m[k] = float(v)
            elif t == C.INDEX_TYPE_STRING_ARRAY:
                if not isinstance(v, (list, tuple)) or any(not isinstance(s, str) for s in v):
                    raise ValidationError(
                        f"expected string array for property {k}, got {type(v).__name__}"
                    )
                m[k] = list(v)
