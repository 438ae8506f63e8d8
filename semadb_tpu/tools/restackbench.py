"""Measure incremental vs full mesh restack at scale (VERDICT r4 #6c).

The mesh serving path caches per-shard engine arrays stacked over the
device mesh; any write used to discard and rebuild EVERY shard's copy.
`update_stacked_shard` replaces one shard's slice in place. This tool
times both on a synthetic 8-shard IVF fleet:

    python -m semadb_tpu.tools.restackbench --n 1000000 --dim 128

Prints one JSON line with full_restack_s / incremental_s per write.
Run on the real chip; on the 8-virtual-device CPU mesh the numbers are
only shape proofs.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000, help="total points")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)

    import jax

    from semadb_tpu.index.ivf import IndexIVF
    from semadb_tpu.models.schema import VectorIVFParams
    from semadb_tpu.parallel.fanout import (
        ivf_stack_geometry,
        pad_ivf_view,
        stack_ivf_states,
        update_stacked_shard,
    )
    from semadb_tpu.parallel.mesh import shard_mesh

    # On the single real chip the mesh degenerates to 1 device — the
    # restack cost (pad + stack + device_put of every shard's arrays vs
    # one shard's slice update) is what's being measured, not collectives.
    mesh = shard_mesh(min(args.shards, len(jax.devices())))
    per = args.n // args.shards
    rng = np.random.default_rng(0)
    params = VectorIVFParams(
        vector_size=args.dim, distance_metric="euclidean", assign_copies=2
    )
    indices = []
    t0 = time.time()
    for s in range(args.shards):
        idx = IndexIVF(params)
        vecs = rng.standard_normal((per, args.dim)).astype(np.float32)
        idx.insert_bulk(np.arange(2, per + 2, dtype=np.int64), vecs)
        idx.sync()
        indices.append(idx)
    build_s = time.time() - t0

    def sync(tree):
        jax.block_until_ready(tree)

    # Full restack
    fulls = []
    stacked = None
    for _ in range(args.repeat):
        t0 = time.time()
        stacked = stack_ivf_states(indices, mesh)
        sync(stacked)
        fulls.append(time.time() - t0)

    # One-shard write + incremental update
    geom = ivf_stack_geometry(indices)
    incs = []
    for r in range(args.repeat):
        v = rng.standard_normal(args.dim).astype(np.float32)
        indices[0].insert_update_delete([(per + 10 + r, v)])
        t0 = time.time()
        view = pad_ivf_view(indices[0].capture_stack_view(), geom)
        stacked = update_stacked_shard(stacked, 0, view, mesh)
        sync(stacked)
        incs.append(time.time() - t0)

    print(
        json.dumps(
            {
                "metric": f"restack{args.n // 1000}k_x{args.shards}",
                "build_s": round(build_s, 1),
                "full_restack_s": [round(x, 3) for x in fulls],
                "incremental_s": [round(x, 3) for x in incs],
                "speedup": round(min(fulls) / max(min(incs), 1e-9), 1),
                "platform": jax.devices()[0].platform,
            }
        )
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
