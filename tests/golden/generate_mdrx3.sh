#!/bin/sh
# Regenerate the compressed-group MDR-X goldens (tests/golden/mdrx3/ with
# MGXHUFF + MGXRLEC bitplane-group containers, trimmed to the reference's
# own 2e-2 request) and the SingleDim-rejection archive (mdrx_sd/).
# Same toolchain recipe as generate_mdrx.sh.
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
env JAX_PLATFORMS=cpu PYTHONPATH="$HERE/../.." \
    python "$HERE/gen_mdrx3_field.py" mdrx3_input.bin
./gen_mdrx refactor3
# fresh process per reference-library call (CompressorCache state leak)
./gen_mdrx reconstruct3 2e-2 --trim
./gen_mdrx refactor_sd
rm -rf "$HERE/mdrx3" "$HERE/mdrx_sd"
cp -r mdrx3 mdrx_sd "$HERE/"
python -c "
import zlib
raw = open('mdrx3_rec_2e-02.bin', 'rb').read()
open('$HERE/mdrx3_rec_2e-02.bin.zz', 'wb').write(zlib.compress(raw[:600000], 9))
"
echo "mdrx3 goldens updated in $HERE"
