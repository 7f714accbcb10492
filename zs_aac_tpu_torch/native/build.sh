#!/bin/sh
# Build the native audio decoder shared library.
cd "$(dirname "$0")"
g++ -O3 -shared -fPIC -o libaudioio.so audioio.cpp
echo "built $(pwd)/libaudioio.so"
