#!/bin/sh
# Run the test suite on the CPU (8 virtual devices; see tests/conftest.py).
cd "$(dirname "$0")/.." || exit 1
exec env JAX_PLATFORMS=cpu python -m pytest tests/ -q "$@"
