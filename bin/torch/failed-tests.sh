#!/bin/bash
# Failure reporter of the port's test sweep (bin/failed-tests.sh): the
# tests.sh results under tests_out/torch/ (or $NBODY_TESTS_OUT) that carry
# Status=FAILED.
REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
OUTDIR="${NBODY_TESTS_OUT:-$REPO_ROOT/tests_out/torch}"
if grep -l "Status=FAILED" "$OUTDIR"/*_mynbody.test.out 2>/dev/null; then
  exit 1
fi
echo "All tests passed."
