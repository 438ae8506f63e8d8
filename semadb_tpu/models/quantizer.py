"""Quantizer parameter models.

Parity reference: models/quantizer.go (Quantizer, BinaryQuantizerParamaters,
ProductQuantizerParameters).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from semadb_tpu.models import constants as C
from semadb_tpu.models.errors import ValidationError


@dataclass
class BinaryQuantizerParams:
    """Reference: models/quantizer.go:31-49.

    ``threshold`` of None means "fit the per-dimension mean threshold after
    trigger_threshold points" (binary.go:145-151 semantics).
    """

    distance_metric: str = C.DISTANCE_HAMMING
    threshold: Optional[float] = None
    trigger_threshold: int = 0

    def validate(self) -> None:
        if self.threshold is None and not (0 <= self.trigger_threshold <= 50000):
            raise ValidationError(
                f"triggerThreshold must be between 0 and 50000, got {self.trigger_threshold}"
            )
        if self.distance_metric not in (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD):
            raise ValidationError(
                f"invalid distance metric for binary quantization, got {self.distance_metric}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "BinaryQuantizerParams":
        return cls(
            distance_metric=d.get("distanceMetric", C.DISTANCE_HAMMING),
            threshold=d.get("threshold"),
            trigger_threshold=d.get("triggerThreshold", 0),
        )

    def to_dict(self) -> dict:
        out: dict = {
            "distanceMetric": self.distance_metric,
            "triggerThreshold": self.trigger_threshold,
        }
        if self.threshold is not None:
            out["threshold"] = self.threshold
        return out


@dataclass
class ProductQuantizerParams:
    """Reference: models/quantizer.go:52-76.

    ``opq`` (beyond-reference extension, default on): learn an orthonormal
    rotation before the subvector split (OPQ, Ge et al. CVPR'13). Same
    code size and query cost (one extra [B,D]x[D,D] matmul per batch —
    matmul rounding), strictly lower quantization error on correlated
    dimensions, so ADC recall rises at equal searchSize. Set false for
    bit-exact parity with the reference's plain PQ."""

    num_centroids: int = 256
    num_subvectors: int = 8
    trigger_threshold: int = 10000
    opq: bool = True

    def validate(self) -> None:
        if not (2 <= self.num_centroids <= 256):
            raise ValidationError(
                f"numCentroids must be between 2 and 256, got {self.num_centroids}"
            )
        if self.num_subvectors < 2:
            raise ValidationError(
                f"numSubVectors must be at least 2, got {self.num_subvectors}"
            )
        if not (1000 <= self.trigger_threshold <= 10000):
            raise ValidationError(
                f"triggerThreshold must be between 1000 and 10000, got {self.trigger_threshold}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "ProductQuantizerParams":
        return cls(
            num_centroids=d.get("numCentroids", 256),
            num_subvectors=d.get("numSubVectors", 8),
            trigger_threshold=d.get("triggerThreshold", 10000),
            opq=d.get("opq", True),
        )

    def to_dict(self) -> dict:
        return {
            "numCentroids": self.num_centroids,
            "numSubVectors": self.num_subvectors,
            "triggerThreshold": self.trigger_threshold,
            "opq": self.opq,
        }


@dataclass
class Quantizer:
    """Reference: models/quantizer.go:5-29."""

    type: str = C.QUANTIZER_NONE
    binary: Optional[BinaryQuantizerParams] = None
    product: Optional[ProductQuantizerParams] = None

    def validate(self) -> None:
        if self.type == C.QUANTIZER_NONE:
            return
        if self.type == C.QUANTIZER_BINARY:
            if self.binary is None:
                raise ValidationError("binary quantizer parameters not provided")
            self.binary.validate()
            return
        if self.type == C.QUANTIZER_PRODUCT:
            if self.product is None:
                raise ValidationError("product quantizer parameters not provided")
            self.product.validate()
            return
        raise ValidationError(f"unknown quantizer type {self.type}")

    @classmethod
    def from_dict(cls, d: dict | None) -> Optional["Quantizer"]:
        if d is None:
            return None
        return cls(
            type=d.get("type", C.QUANTIZER_NONE),
            binary=BinaryQuantizerParams.from_dict(d["binary"]) if d.get("binary") else None,
            product=ProductQuantizerParams.from_dict(d["product"]) if d.get("product") else None,
        )

    def to_dict(self) -> dict:
        out: dict = {"type": self.type}
        if self.binary is not None:
            out["binary"] = self.binary.to_dict()
        if self.product is not None:
            out["product"] = self.product.to_dict()
        return out
