#!/usr/bin/env bash
# AddressSanitizer gate for the port's host library (io/csrc/*.cpp), the
# counterpart of the JAX package's scripts/run_asan.sh. Builds an
# instrumented libgd_host.so into build/gd_host_asan/, points the loader at
# it (GD_HOST_SO, io/build.py) and runs asan_exercise.py under it.
#
#   bash genome_downsampler_tpu_torch/scripts/run_asan.sh
set -euo pipefail
cd "$(dirname "$0")/../.."

ASAN_SO=$(g++ -print-file-name=libasan.so)
OUT_DIR=build/gd_host_asan
mkdir -p "$OUT_DIR"
OUT="$OUT_DIR/libgd_host.so"
g++ -O1 -g -std=c++17 -shared -fPIC -fsanitize=address \
    genome_downsampler_tpu_torch/io/csrc/*.cpp -o "$OUT" -lz -lpthread

# Leak detection is off because the CPython interpreter itself reports
# leaks at exit. The exercise is run by path, without pytest: torch's
# wheels may abort under ASan's interceptors, and the scripts package
# imports torch.
LD_PRELOAD="$ASAN_SO" \
ASAN_OPTIONS=detect_leaks=0 \
GD_HOST_SO="$PWD/$OUT" \
PYTHONPATH="$PWD" \
python3 -u genome_downsampler_tpu_torch/scripts/asan_exercise.py
