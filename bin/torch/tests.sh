#!/bin/bash
# One golden-diff test of the port (bin/tests.sh):
#   tests.sh NP VARIANT N
# NP ranks (one rank a device) x the force path:
#   trig   — dense, the reference's trig decomposition (parity path)
#   fast   — dense, transcendental-free rsqrt path
#   pallas — --pallas: the hand-written kernels on a card, their plain
#            PyTorch versions on the CPU
# NP > 1 runs gloo ranks on the CPU; NP = 1 runs on the card unless
# NBODY_PLATFORM=cpu.  Each run is diffed against the same variant's
# --devices=1 run on the same platform (re-partitioning invariance); the
# CPU's trig oracle must itself equal the golden fixture
# tests/fixtures/${N}_MY_REF_OUTPUT where one exists.  Numeric VARIANT
# values (the reference's CPUs argument) mean trig.  Results go to
# tests_out/torch/ (or $NBODY_TESTS_OUT).
set -u
. "$(dirname "$0")/common.sh"

NP="${1:?usage: tests.sh NP VARIANT N}"
VARIANT="${2:?usage: tests.sh NP VARIANT N}"
N="${3:?usage: tests.sh NP VARIANT N}"
STEPS="${STEPS:-1000}"

case "$VARIANT" in
  trig|[0-9]*) VARIANT=trig; FLAGS="" ;;
  fast)        FLAGS="--fast" ;;
  pallas)      FLAGS="--pallas" ;;
  *) echo "unknown variant: $VARIANT (trig|fast|pallas)" >&2; exit 2 ;;
esac

PLAT="$(nbody_platform "$NP")"
ARENA=$(ensure_arena)
OUTDIR="${NBODY_TESTS_OUT:-$REPO_ROOT/tests_out/torch}"
mkdir -p "$OUTDIR"
REF="$OUTDIR/${N}_${VARIANT}_${PLAT}_s${STEPS}_MY_REF_OUTPUT"
BASE="$OUTDIR/${NP}_${VARIANT}_${N}_mynbody.test"

if [ ! -f "$REF" ]; then
  # Only a complete oracle run is cached.
  if ! NBODY_PLATFORM="$PLAT" $NBODY "$N" 0 "$ARENA" "$STEPS" --devices=1 \
      $FLAGS > "$REF.tmp" 2>/dev/null || [ ! -s "$REF.tmp" ]; then
    rm -f "$REF.tmp"
    echo "ORACLE GENERATION FAILED: N=$N VARIANT=$VARIANT STEPS=$STEPS" >&2
    exit 3
  fi
  GOLD="$REPO_ROOT/tests/fixtures/${N}_MY_REF_OUTPUT"
  if [ "$VARIANT" = trig ] && [ "$PLAT" = cpu ] && [ "$STEPS" = 1000 ] \
      && [ -f "$GOLD" ] && ! diff -q "$GOLD" "$REF.tmp" >/dev/null; then
    rm -f "$REF.tmp"
    echo "ORACLE MISMATCH: N=$N trig on the CPU != $GOLD" >&2
    exit 3
  fi
  mv "$REF.tmp" "$REF"
fi

NBODY_PLATFORM="$PLAT" $NBODY "$N" 0 "$ARENA" "$STEPS" --devices="$NP" \
  $FLAGS > "$BASE.out" 2> "$BASE.err"
if diff "$REF" "$BASE.out" > "$BASE.diff"; then
  echo "STATUS=PASSED" >> "$BASE.out"
else
  echo "Status=FAILED" >> "$BASE.out"
fi
