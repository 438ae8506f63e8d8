#!/usr/bin/env bash
# Manual 3-node local cluster for testing (reference: run_cluster.sh).
# HTTP ports 8081/8084/8085, RPC ports 9898/9899/9900.
#
# One JAX process per GPU: node A runs on GPU 0, B on GPU 1, C on GPU 2.
# A JAX process reserves 75% of its card's memory when it first uses it,
# so three nodes on ONE card must each take a share instead:
#   SEMADB_ONE_CARD=1 ./run_cluster.sh   # CUDA_VISIBLE_DEVICES=0 and
#                                        # XLA_PYTHON_CLIENT_MEM_FRACTION=0.3
set -e
trap 'kill 0' EXIT
i=0
for s in A B C; do
  if [ -n "$SEMADB_ONE_CARD" ]; then
    CUDA_VISIBLE_DEVICES=0 XLA_PYTHON_CLIENT_MEM_FRACTION=0.3 \
      SEMADB_CONFIG=config/server$s.yaml python -m semadb_tpu.main &
  else
    CUDA_VISIBLE_DEVICES=$i SEMADB_CONFIG=config/server$s.yaml python -m semadb_tpu.main &
  fi
  i=$((i + 1))
done
wait
