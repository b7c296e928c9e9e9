#!/bin/sh
# Build the port's native codec (minlz_tpu_torch/native/*.cpp) with
# ThreadSanitizer or AddressSanitizer into build/minlz_tpu_torch/ and run the
# thread-stress tests against it, then restore the normal build.
# Usage: minlz_tpu_torch/scripts/sanitize_native.sh [tsan|asan] [pytest args]
set -eu
MODE="${1:-tsan}"
[ "$#" -gt 0 ] && shift
case "$MODE" in
  tsan) FLAG=-fsanitize=thread ;;
  asan) FLAG=-fsanitize=address ;;
  *) echo "usage: $0 [tsan|asan] [pytest args]" >&2; exit 2 ;;
esac
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
SO="$ROOT/build/minlz_tpu_torch/libminlz_native.so"
mkdir -p "$(dirname "$SO")"
# The loader rebuilds only when a source is newer than the library, so the
# sanitized build is the one the tests load.
g++ -O1 -g -std=c++17 -fPIC -shared -fvisibility=hidden $FLAG \
  "$ROOT"/minlz_tpu_torch/native/*.cpp -o "$SO"
# The sanitizer's runtime has to be loaded first into the Python process.
# The interpreter and torch leak at exit by design, so AddressSanitizer's
# leak report is off unless ASAN_OPTIONS says otherwise.
if [ "$MODE" = tsan ]; then
  PRELOAD="$(g++ -print-file-name=libtsan.so)"
else
  PRELOAD="$(g++ -print-file-name=libasan.so)"
  ASAN_OPTIONS="${ASAN_OPTIONS:-detect_leaks=0}"
  export ASAN_OPTIONS
fi
STATUS=0
(cd "$ROOT" && LD_PRELOAD="$PRELOAD" JAX_PLATFORMS=cpu \
  python -m pytest tests/test_torch_native_threads.py -v -p no:cacheprovider \
  "$@") || STATUS=$?
rm -f "$SO"
# The normal build, as the package's loader makes it.
(cd "$ROOT" && python -c "from minlz_tpu_torch.native.build import \
get_lib, build_error; assert get_lib() is not None, build_error()")
exit "$STATUS"
