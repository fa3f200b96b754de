#!/bin/sh
# Run every example headless on CPU (multi_device gets the 8-device
# virtual mesh). Exit nonzero if any example fails.
cd "$(dirname "$0")/.." || exit 1
rc=0
for f in high_level_api device_buffer_api roi_compression qoi_average \
         mdr_progressive adaptive_resolution io_operator \
         lagrange_optimizer xgc_casestudy; do
    if env PYTHONPATH="$PWD" JAX_PLATFORMS=cpu \
        python "examples/$f.py" >/dev/null 2>&1; then
        echo "$f OK"
    else
        echo "$f FAILED"; rc=1
    fi
done
if env PYTHONPATH="$PWD" JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/multi_device.py >/dev/null 2>&1; then
    echo "multi_device OK"
else
    echo "multi_device FAILED"; rc=1
fi
exit $rc
