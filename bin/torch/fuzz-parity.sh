#!/bin/bash
# Randomized differential parity fuzz of the port (bin/fuzz-parity.sh): draw
# COUNT seeded configurations from bin/fuzz_gen.py's parity stream and diff
# the port's CLI, in float64, through the drawn sharding (--devices=K,
# --comm=ring, or a 2-D --mesh2d=RxC) against the reference binary's own
# output, byte for byte.
#
#   fuzz-parity.sh [COUNT] [SEED]     (defaults: 5 configs, seed 20260818)
#
# The oracle: the committed outputs of the reference binary in
# $NBODY_FUZZ_ORACLE (default tests_out/fuzz, only read), else
# $NBODY_REF_BIN's run into the output directory; when an oracle is missing
# and the binary is absent the script reports SKIPPED and exits 0.  Results
# go to $NBODY_FUZZ_OUT (default tests_out/torch_fuzz): fuzz_<N>_<STEPS>_
# <flags>.{out,err,diff}, the .out ending in STATUS=PASSED or Status=FAILED.
# Several ranks run as gloo processes on the CPU; a single rank runs on
# $NBODY_FUZZ_PLATFORM (cpu by default, or cuda).
set -u
. "$(dirname "$0")/common.sh"

COUNT="${1:-5}"
SEED="${2:-20260818}"
fuzz_setup parity "$COUNT" "$SEED" fuzz   # sets REFBIN, ORACLE, OUT, CFGS

fail=0
ran=0
while read -r N STEPS FLAGS; do
  if ! ref=$(fuzz_oracle "$REFBIN" "$OUT/arena.ppm" "$ORACLE" "$OUT" \
               "$N" "$STEPS"); then
    echo "ORACLE GENERATION FAILED: N=$N steps=$STEPS"
    fail=1
    continue
  fi
  ran=$((ran + 1))
  base="$OUT/fuzz_${N}_${STEPS}_$(printf '%s' "$FLAGS" | tr ' =' '__')"
  fuzz_cli "$N" 0 "$OUT/arena.ppm" "$STEPS" $FLAGS \
    < /dev/null > "$base.out" 2> "$base.err"
  if diff "$ref" "$base.out" > "$base.diff"; then
    echo "STATUS=PASSED" >> "$base.out"
    echo "PASSED N=$N steps=$STEPS $FLAGS"
  else
    # The casing of bin/tests.sh's marker, which failed-tests.sh greps.
    echo "Status=FAILED" >> "$base.out"
    echo "FAILED N=$N steps=$STEPS $FLAGS (see $base.diff)"
    fail=1
  fi
done < "$CFGS"

fuzz_check_count "$ran" "$COUNT" || fail=1
exit "$fail"
