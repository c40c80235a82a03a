#!/bin/bash
# Test sweep of the port (bin/run-tests.sh): NP ranks in 1..8 x variant in
# $VARIANTS (trig, fast, pallas) at N=$N (128), each through tests.sh;
# reports failures at the end.
set -u
BIN="$(dirname "$0")"
N="${N:-128}"
VARIANTS="${VARIANTS:-trig fast pallas}"

for VARIANT in $VARIANTS; do
  for NP in 1 2 3 4 5 6 7 8; do
    echo "== NP=$NP VARIANT=$VARIANT N=$N =="
    "$BIN/tests.sh" "$NP" "$VARIANT" "$N" "$@" || exit $?
  done
done

"$BIN/failed-tests.sh"
