"""Shared constants: distance metrics, index types, operators, quantizers.

Parity reference: models/constants.go (all constant blocks).
"""

# Distance metrics (reference: models/constants.go:7-14)
DISTANCE_EUCLIDEAN = "euclidean"
DISTANCE_COSINE = "cosine"
DISTANCE_DOT = "dot"
DISTANCE_HAMMING = "hamming"
DISTANCE_JACCARD = "jaccard"
DISTANCE_HAVERSINE = "haversine"

DISTANCE_METRICS = frozenset(
    {
        DISTANCE_EUCLIDEAN,
        DISTANCE_COSINE,
        DISTANCE_DOT,
        DISTANCE_HAMMING,
        DISTANCE_JACCARD,
        DISTANCE_HAVERSINE,
    }
)

# Index types (reference: models/constants.go:18-26)
INDEX_TYPE_VECTOR_FLAT = "vectorFlat"
INDEX_TYPE_VECTOR_VAMANA = "vectorVamana"
INDEX_TYPE_VECTOR_IVF = "vectorIVF"
# Multi-view index with exact weighted score fusion — no
# reference counterpart (index/fused.py rationale; the reference's
# closest surface is multi-index hybrid search, search.go:211-298).
INDEX_TYPE_VECTOR_FUSED = "vectorFused"
INDEX_TYPE_TEXT = "text"
INDEX_TYPE_STRING = "string"
INDEX_TYPE_INTEGER = "integer"
INDEX_TYPE_FLOAT = "float"
INDEX_TYPE_STRING_ARRAY = "stringArray"

INDEX_TYPES = frozenset(
    {
        INDEX_TYPE_VECTOR_FLAT,
        INDEX_TYPE_VECTOR_VAMANA,
        INDEX_TYPE_VECTOR_IVF,
        INDEX_TYPE_VECTOR_FUSED,
        INDEX_TYPE_TEXT,
        INDEX_TYPE_STRING,
        INDEX_TYPE_INTEGER,
        INDEX_TYPE_FLOAT,
        INDEX_TYPE_STRING_ARRAY,
    }
)

# Query operators (reference: models/constants.go:30-42)
OPERATOR_NEAR = "near"
OPERATOR_CONTAINS_ALL = "containsAll"
OPERATOR_CONTAINS_ANY = "containsAny"
OPERATOR_EQUALS = "equals"
OPERATOR_NOT_EQUALS = "notEquals"
OPERATOR_STARTS_WITH = "startsWith"
OPERATOR_GREATER_THAN = "greaterThan"
OPERATOR_GREATER_OR_EQ = "greaterThanOrEquals"
OPERATOR_LESS_THAN = "lessThan"
OPERATOR_LESS_OR_EQ = "lessThanOrEquals"
OPERATOR_IN_RANGE = "inRange"

RANGE_OPERATORS = frozenset(
    {
        OPERATOR_EQUALS,
        OPERATOR_NOT_EQUALS,
        OPERATOR_GREATER_THAN,
        OPERATOR_GREATER_OR_EQ,
        OPERATOR_LESS_THAN,
        OPERATOR_LESS_OR_EQ,
        OPERATOR_IN_RANGE,
    }
)

# Quantizer types (reference: models/constants.go:46-50)
QUANTIZER_NONE = "none"
QUANTIZER_BINARY = "binary"
QUANTIZER_PRODUCT = "product"

# Special update sentinel: assigning this value to a key in an update request
# removes the key from the point (reference: shard/shard.go:41,276-281).
DELETE_VALUE = "_delete"

# Reserved node ids (reference: shard/idcounter.go:11-23): 0 is "nil",
# 1 is the graph start/medoid node. User points get ids >= 2.
NIL_NODE_ID = 0
START_NODE_ID = 1
