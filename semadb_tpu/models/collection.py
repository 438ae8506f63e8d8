"""Collection and user plan models.

Parity reference: models/collection.go, models/userplan.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from semadb_tpu.models.schema import IndexSchema


@dataclass
class UserPlan:
    """Reference: models/userplan.go."""

    name: str = "default"
    max_collections: int = 10
    max_collection_point_count: int = 10_000_000
    max_point_size: int = 100 * 1024
    shard_backup_frequency: int = 0  # seconds between backups; 0 disables
    shard_backup_count: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "UserPlan":
        return cls(
            name=d.get("name", "default"),
            max_collections=int(d.get("maxCollections", 10)),
            max_collection_point_count=int(d.get("maxCollectionPointCount", 10_000_000)),
            max_point_size=int(d.get("maxPointSize", 100 * 1024)),
            shard_backup_frequency=int(d.get("shardBackupFrequency", 0)),
            shard_backup_count=int(d.get("shardBackupCount", 0)),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "maxCollections": self.max_collections,
            "maxCollectionPointCount": self.max_collection_point_count,
            "maxPointSize": self.max_point_size,
            "shardBackupFrequency": self.shard_backup_frequency,
            "shardBackupCount": self.shard_backup_count,
        }


@dataclass
class Collection:
    """Reference: models/collection.go."""

    user_id: str
    id: str
    index_schema: IndexSchema
    replicas: int = 1
    timestamp: int = 0
    created_at: int = 0
    shard_ids: List[str] = field(default_factory=list)
    user_plan: UserPlan = field(default_factory=UserPlan)
    # Shard-per-device mesh serving (beyond reference — the reference's
    # only data plane is host RPC fan-out, cluster/actions.go:274-378):
    # "host" = rendezvous-routed RPC fan-out; "device" = this node stacks
    # its local shards' device indices along a jax.sharding.Mesh axis and
    # serves eligible vector queries with ONE sharded_*_search dispatch
    # (all-gather top-k merge) instead of N per-shard calls.
    shard_placement: str = "host"

    def to_dict(self) -> dict:
        return {
            "userId": self.user_id,
            "id": self.id,
            "replicas": self.replicas,
            "timestamp": self.timestamp,
            "createdAt": self.created_at,
            "shardIds": list(self.shard_ids),
            "userPlan": self.user_plan.to_dict(),
            "indexSchema": self.index_schema.to_dict(),
            "shardPlacement": self.shard_placement,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Collection":
        return cls(
            user_id=d["userId"],
            id=d["id"],
            index_schema=IndexSchema.from_dict(d.get("indexSchema", {})),
            replicas=int(d.get("replicas", 1)),
            timestamp=int(d.get("timestamp", 0)),
            created_at=int(d.get("createdAt", 0)),
            shard_ids=list(d.get("shardIds", [])),
            user_plan=UserPlan.from_dict(d.get("userPlan", {})),
            shard_placement=d.get("shardPlacement", "host"),
        )
