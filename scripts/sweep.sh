#!/usr/bin/env bash
# Benchmark sweep — the reference's scripts/times.sh grid
# (/root/reference/scripts/times.sh:5-66: CCD k x T, ALS k, 3 repeats)
# driven through the Python sweep harness. Datasets: pass converted dataset
# dirs, or synthetic specs for machines without the real dumps.
set -euo pipefail
cd "$(dirname "$0")/.."

DATASET="${1:-synthetic:m=69878,n=10677,nnz=10000000}"
OUT="${2:-chiprun_out/sweep.jsonl}"
mkdir -p "$(dirname "$OUT")"

# cli.bench keeps its persistent compile cache in $JAX_COMPILATION_CACHE_DIR
# or .jax_cache/ (utils/cache.py), so each (k, T) program compiles once

python -m cuda_recommender_tpu.cli.bench \
    --dataset "$DATASET" \
    --solvers ccd --ks 1,5,10,15,20,25,30,40,50 --inners 1,3,5,7 \
    --lambda 0.1 --iters 10 --repeats 3 -o "$OUT"

python -m cuda_recommender_tpu.cli.bench \
    --dataset "$DATASET" \
    --solvers als --ks 1,5,10,15,20,25,30,40,50 \
    --lambda 0.1 --iters 10 --repeats 3 -o "$OUT"

echo "sweep written to $OUT"
