#!/usr/bin/env bash
# Build the native host ops: bash native/build.sh OUT.so
# (repeatresolver_tpu/utils/native.py picks OUT under native/build/,
# keyed to the sources and the CPU, and calls this on first use).
#
# Compile to a temp file and rename into place: long-running pipeline
# processes keep the old .so mmapped, and overwriting the mapped inode
# in place would corrupt their text pages. rename() gives them the old
# inode until exit while new processes pick up the new build.
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
OUT="$1"
mkdir -p "$(dirname "$OUT")"
TMP="$OUT.tmp.$$"
trap 'rm -f "$TMP"' EXIT
g++ -O3 -march=native -fopenmp -shared -fPIC \
    -o "$TMP" "$HERE/host_ops.cpp"
mv -f "$TMP" "$OUT"
echo "built $OUT"
