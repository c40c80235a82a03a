#!/bin/bash
# Randomized differential parity fuzz of the port, kernel and process axes
# (bin/fuzz-parity-v2.sh): the parity2 stream of bin/fuzz_gen.py also draws
# the force path (trig by default, --fast or --pallas; in float64 all three
# print the reference's bytes) and a process count.  A PROCS=2 config runs
# the whole CLI under the two-process launcher bin/torch/multihost-cli.sh,
# so rank 0's printout is diffed against the reference binary.
#
# In the JAX repo a PROCS=2 config was 2 processes x 2 virtual devices under
# --devices=4.  The port has one device per process, so here it is 2 ranks
# (--devices=2).  What this axis tests is the launcher path and rank 0's
# printout, and the printout does not depend on the sharding.
#
#   fuzz-parity-v2.sh [COUNT] [SEED]  (defaults: 5 configs, seed 20260818)
#
# The oracle: $NBODY_FUZZ_ORACLE (default tests_out/fuzz_v2, only read),
# else $NBODY_REF_BIN's run into the output directory; SKIPPED and exit 0
# when an oracle is missing and the binary is absent.  Results go to
# $NBODY_FUZZ_OUT (default tests_out/torch_fuzz_v2).  The launcher's port is
# $NBODY_FUZZ_PORT (default 11000) plus the config's index.
set -u
. "$(dirname "$0")/common.sh"

COUNT="${1:-5}"
SEED="${2:-20260818}"
fuzz_setup parity2 "$COUNT" "$SEED" fuzz_v2   # sets REFBIN, ORACLE, OUT, CFGS

fail=0
ran=0
idx=0
while read -r N STEPS PROCS FLAGS; do
  idx=$((idx + 1))
  if ! ref=$(fuzz_oracle "$REFBIN" "$OUT/arena.ppm" "$ORACLE" "$OUT" \
               "$N" "$STEPS"); then
    echo "ORACLE GENERATION FAILED: N=$N steps=$STEPS"
    fail=1
    continue
  fi
  ran=$((ran + 1))
  base="$OUT/fuzz_${N}_${STEPS}_p${PROCS}_$(printf '%s' "$FLAGS" | tr ' =' '__')"
  if [ "$PROCS" -eq 1 ]; then
    fuzz_cli "$N" 0 "$OUT/arena.ppm" "$STEPS" $FLAGS \
      < /dev/null > "$base.out" 2> "$base.err"
  else
    # A port per config keeps back-to-back runs clear of each other's
    # TIME_WAIT.  multihost-cli.sh supplies the arena (1024x768, as
    # $OUT's copy) and --devices, and runs every rank on the CPU.
    PORT=$((${NBODY_FUZZ_PORT:-11000} + idx)) \
      bash "$REPO_ROOT/bin/torch/multihost-cli.sh" \
      "$PROCS" "$N" "$STEPS" $FLAGS --dtype=float64 \
      < /dev/null > "$base.out" 2> "$base.err"
  fi
  if diff "$ref" "$base.out" > "$base.diff"; then
    echo "STATUS=PASSED" >> "$base.out"
    echo "PASSED N=$N steps=$STEPS p=$PROCS $FLAGS"
  else
    # The casing of bin/tests.sh's marker, which failed-tests.sh greps.
    echo "Status=FAILED" >> "$base.out"
    echo "FAILED N=$N steps=$STEPS p=$PROCS $FLAGS (see $base.diff)"
    fail=1
  fi
done < "$CFGS"

fuzz_check_count "$ran" "$COUNT" || fail=1
exit "$fail"
