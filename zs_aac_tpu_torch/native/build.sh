#!/bin/sh
# Build the native audio decoder shared library. g++ writes a temporary name
# that is then renamed into place, so a process loading the library never
# sees a half-written file; a failed build exits non-zero and leaves nothing.
set -e
cd "$(dirname "$0")"
tmp="libaudioio.so.$$.tmp"
trap 'rm -f "$tmp"' EXIT
g++ -O3 -shared -fPIC -o "$tmp" audioio.cpp
mv -f "$tmp" libaudioio.so
echo "built $(pwd)/libaudioio.so"
