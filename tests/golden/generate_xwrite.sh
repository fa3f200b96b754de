#!/bin/sh
# Regenerate the cross-WRITE golden artifacts: streams written by
# mgard_tpu.formats.ref_stream.compress_reference from the committed
# ref_input_3d65_f32_lz4_abs.bin field, then decompressed by the REFERENCE
# library (gen_xwrite_check.cpp) to prove it accepts them. Requires g++,
# protoc, libprotobuf, libzstd, libz plus the python package.
set -e
REF=${REF:-/root/reference}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "$HERE/../.." && pwd)
BUILD=$(mktemp -d)

# 1) write the streams with this framework (CPU; deterministic)
env PYTHONPATH="$REPO" JAX_PLATFORMS=cpu python - << EOF
import math
import numpy as np
from mgard_tpu.formats import ref_stream as rs
v = np.fromfile("$HERE/ref_input_3d65_f32_lz4_abs.bin", np.float32).reshape(65, 65, 65)
open("$HERE/xwrite_3d65_f32_abs.mgard", "wb").write(rs.compress_reference(v, 1e-3, math.inf))
open("$HERE/xwrite_3d65_f32_s0.mgard", "wb").write(rs.compress_reference(v, 1e-3, 0.0))
open("$HERE/xwrite_3d65_f64_abs.mgard", "wb").write(rs.compress_reference(v.astype(np.float64), 1e-4, math.inf))
print("wrote 3 xwrite blobs")
EOF

# 2) decode them with the reference library
cd "$BUILD"
protoc --proto_path="$REF/src" --cpp_out=. mgard.proto
mkdir -p proto && cp mgard.pb.h proto/
sed -e 's/#cmakedefine01 MGARD_ENABLE_SERIAL/#define MGARD_ENABLE_SERIAL 1/' \
    -e 's/#cmakedefine01 \(.*\)/#define \1 0/' \
    "$REF/include/MGARDXConfig.h.in" > MGARDXConfig.h
sed -e 's/@MGARD_VERSION@/1.6.0/; s/@MGARD_VERSION_MAJOR@/1/;
        s/@MGARD_VERSION_MINOR@/6/; s/@MGARD_VERSION_PATCH@/0/;
        s/@MGARD_FILE_VERSION_MAJOR@/1/; s/@MGARD_FILE_VERSION_MINOR@/0/;
        s/@MGARD_FILE_VERSION_PATCH@/0/;
        s/#cmakedefine[^\n]*//' \
    "$REF/include/MGARDConfig.hpp.in" > MGARDConfig.hpp
g++ -O1 -w -std=c++17 -I"$REF/include" -I. \
    "$HERE/gen_xwrite_check.cpp" mgard.pb.cc \
    "$REF/src/mgard-x/Config/Config.cpp" \
    "$REF/src/mgard-x/Metadata/Metadata.cpp" \
    "$REF/src/mgard-x/RuntimeX/Utilities/Log.cpp" \
    "$REF/src/mgard-x/RuntimeX/DeviceAdapters/DeviceAdapterSerial.cpp" \
    "$REF/src/mgard-x/RuntimeX/AutoTuners/AutoTunerSerial.cpp" \
    -lprotobuf -lzstd -lz -o gen_xwrite_check
# one process per decode (the reference cache leaks state across shapes)
./gen_xwrite_check "$HERE/xwrite_3d65_f32_abs.mgard" f32 65 65 65 \
    "$HERE/xwrite_dec_3d65_f32_abs.bin"
./gen_xwrite_check "$HERE/xwrite_3d65_f32_s0.mgard" f32 65 65 65 \
    "$HERE/xwrite_dec_3d65_f32_s0.bin"
./gen_xwrite_check "$HERE/xwrite_3d65_f64_abs.mgard" f64 65 65 65 \
    "$HERE/xwrite_dec_3d65_f64_abs.bin"
echo "cross-write golden artifacts updated in $HERE"
