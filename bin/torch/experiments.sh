#!/bin/bash
# Parallel experiment sweep of the port (bin/experiments.sh):
# REPLICATES x N in {512,1024,4096,10000} x gloo ranks in {2,4,6,8} on the
# CPU, STEPS steps (100), CSV rows of the reference contract
# (nbody-par.c:956).  Pass --measure-comm for the comm column, --fast for
# the transcendental-free path, --xps-precise for 6-decimal COMMTIME/RATIO
# (which defaults to a separate experiments_precise-torch.csv).
# Output: $CSV (default experiments-torch.csv).
set -u
. "$(dirname "$0")/common.sh"

REPLICATES="${REPLICATES:-3}"
STEPS="${STEPS:-100}"
SIZES="${SIZES:-512 1024 4096 10000}"
RANKS="${RANKS:-2 4 6 8}"
DEFAULT_CSV="$REPO_ROOT/experiments-torch.csv"
case " $* " in
  *" --xps-precise "*) DEFAULT_CSV="$REPO_ROOT/experiments_precise-torch.csv" ;;
esac
CSV="${CSV:-$DEFAULT_CSV}"
ARENA=$(ensure_arena)

echo "SIZE,NODES,CPUS_PER_NODE,NBODIES,RTIME,COMMTIME,RATIO,GFLOPS" > "$CSV"
for rep in $(seq 1 "$REPLICATES"); do
  for N in $SIZES; do
    for NP in $RANKS; do
      echo "rep=$rep N=$N NP=$NP" >&2
      if ! nbody_cpu "$N" 0 "$ARENA" "$STEPS" --run-xps --devices="$NP" \
          "$@" >> "$CSV" 2>/dev/null; then
        echo "FAILED: N=$N NP=$NP" >&2
        exit 1
      fi
    done
  done
done
echo "wrote $CSV"
