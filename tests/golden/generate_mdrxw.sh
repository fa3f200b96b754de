#!/bin/sh
# Regenerate the WRITE-side MDR-X goldens: our write_mdrx archive of the
# 33^3 make_field input (tests/golden/mdrxw/) plus the REFERENCE build's
# own progressive reconstructions of that archive (mdrxw_rec_*.bin.zz).
# Same toolchain recipe as generate_mdrx.sh; gen_mdrx's `reconstruct`
# mode reads a directory named mdrx, so our archive is staged there.
set -e
REF=${REF:-/root/reference}
HERE=$(cd "$(dirname "$0")" && pwd)
BUILD=$(mktemp -d)
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
    "$HERE/gen_mdrx.cpp" mgard.pb.cc \
    "$REF/src/mgard-x/Config/Config.cpp" \
    "$REF/src/mgard-x/Metadata/Metadata.cpp" \
    "$REF/src/mgard-x/RuntimeX/Utilities/Log.cpp" \
    "$REF/src/mgard-x/RuntimeX/DeviceAdapters/DeviceAdapterSerial.cpp" \
    "$REF/src/mgard-x/RuntimeX/AutoTuners/AutoTunerSerial.cpp" \
    -lprotobuf -lzstd -lz -o gen_mdrx
cp "$HERE/mdrx_input.bin" .
env JAX_PLATFORMS=cpu PYTHONPATH="$HERE/../.." \
    python -c "
import numpy as np
from mgard_tpu.formats.mdrx_stream import write_mdrx
v = np.fromfile('mdrx_input.bin', np.float32).reshape(33, 33, 33)
write_mdrx('mdrx', v)
"
# fresh process per reference-library call (CompressorCache state leak)
./gen_mdrx reconstruct 1e-1
./gen_mdrx reconstruct 1e-3
# finite-s (L2) requests on our honest squared-error tables: the printed
# "requested planes" lines are pinned in test_mdrx_finite_s_requests
./gen_mdrx reconstruct 1e-1 0
./gen_mdrx reconstruct 1e-3 0
rm -rf "$HERE/mdrxw"
cp -r mdrx "$HERE/mdrxw"
python -c "
import zlib
for t in ('1e-01', '1e-03'):
    raw = open(f'mdrx_rec_{t}.bin', 'rb').read()
    open(f'$HERE/mdrxw_rec_{t}.bin.zz', 'wb').write(zlib.compress(raw, 9))
"
echo "mdrxw goldens updated in $HERE"
