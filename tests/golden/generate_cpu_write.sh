#!/bin/sh
# Regenerate the CPU-generation cross-WRITE goldens: streams written by
# mgard_tpu.formats.cpu_stream.compress_cpu, then decompressed by the
# REFERENCE CPU library (gen_cpu_write_check.cpp) to prove it accepts
# them. Requires the reference checkout plus protoc, g++, libprotobuf,
# libzstd, libz and the python package.
set -e
REF=${REF:-/root/reference}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "$HERE/../.." && pwd)
BUILD=$(mktemp -d)

# 1) write the streams with this framework (deterministic)
env PYTHONPATH="$REPO" JAX_PLATFORMS=cpu python - << EOF
import math
import numpy as np
from mgard_tpu.formats.cpu_stream import compress_cpu
v = np.fromfile("$HERE/input_3d15x16x17_f64.bin", np.float64).reshape(15, 16, 17)
open("$HERE/cpuwrite_3d151617_f64_sinf.mgard", "wb").write(
    compress_cpu(v, 1e-3, math.inf))
open("$HERE/cpuwrite_3d151617_f64_s0.mgard", "wb").write(
    compress_cpu(v, 1e-3, 0.0))
v32 = np.fromfile("$HERE/input_3d9x9x17_f32.bin", np.float32).reshape(9, 9, 17)
open("$HERE/cpuwrite_3d9917_f32_sinf.mgard", "wb").write(
    compress_cpu(v32, 1e-3, math.inf))
c0 = np.fromfile("$HERE/cpu_coords_2d179_f64_nonuni_d0.bin", np.float64)
c1 = np.fromfile("$HERE/cpu_coords_2d179_f64_nonuni_d1.bin", np.float64)
vn = np.fromfile("$HERE/cpu_input_2d179_f64_nonuni.bin", np.float64).reshape(17, 9)
open("$HERE/cpuwrite_2d179_f64_nonuni.mgard", "wb").write(
    compress_cpu(vn, 1e-3, math.inf, coords=[c0, c1]))
print("wrote 4 cpuwrite blobs")
EOF

# 2) decode them with the reference CPU library
cd "$BUILD"
protoc --proto_path="$REF/src" --cpp_out=. mgard.proto
mkdir -p proto && cp mgard.pb.h proto/
sed -e 's/@MGARD_VERSION@/1.6.0/; s/@MGARD_VERSION_MAJOR@/1/;
        s/@MGARD_VERSION_MINOR@/6/; s/@MGARD_VERSION_PATCH@/0/;
        s/@MGARD_FILE_VERSION_MAJOR@/1/; s/@MGARD_FILE_VERSION_MINOR@/0/;
        s/@MGARD_FILE_VERSION_PATCH@/0/;
        s/#cmakedefine[^\n]*//' \
    "$REF/include/MGARDConfig.hpp.in" > MGARDConfig.hpp
sed -e 's/#cmakedefine01 \(.*\)/#define \1 0/' \
    "$REF/include/MGARDXConfig.h.in" > MGARDXConfig.h
g++ -O2 -w -std=c++17 -DMGARD_ZSTD -I"$REF/include" -I. \
    "$HERE/gen_cpu_write_check.cpp" mgard.pb.cc \
    "$REF/src/mgard/compress.cpp" "$REF/src/mgard/compress_internal.cpp" \
    "$REF/src/mgard/compressors.cpp" "$REF/src/mgard/format.cpp" \
    -lprotobuf -lzstd -lz -o gen_cpu_write_check
for tag in 3d151617_f64_sinf 3d151617_f64_s0 3d9917_f32_sinf \
           2d179_f64_nonuni; do
  ./gen_cpu_write_check "$HERE/cpuwrite_${tag}.mgard" \
      "$HERE/cpuwrite_dec_${tag}.bin"
done
echo "cpuwrite goldens updated in $HERE"
