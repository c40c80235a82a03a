#!/bin/bash
# Sequential experiment sweep of the port (bin/sequential-experiments.sh):
# REPLICATES x N in {512,1024,4096,10000}, STEPS steps (100), one rank, CSV
# NBODIES,RTIME,GFLOPS.  On the card unless NBODY_PLATFORM=cpu; extra
# arguments go to the CLI (e.g. --pallas).  Output: $CSV (default
# sequential-experiments-torch.csv).
set -u
. "$(dirname "$0")/common.sh"

REPLICATES="${REPLICATES:-3}"
STEPS="${STEPS:-100}"
SIZES="${SIZES:-512 1024 4096 10000}"
CSV="${CSV:-$REPO_ROOT/sequential-experiments-torch.csv}"
ARENA=$(ensure_arena)

echo "NBODIES,RTIME,GFLOPS" > "$CSV"
for rep in $(seq 1 "$REPLICATES"); do
  for N in $SIZES; do
    echo "rep=$rep N=$N" >&2
    if ! NBODY_PLATFORM="$(nbody_platform 1)" \
        $NBODY "$N" 0 "$ARENA" "$STEPS" --run-xps --devices=1 "$@" \
        >> "$CSV" 2>/dev/null; then
      echo "FAILED: N=$N" >&2
      exit 1
    fi
  done
done
echo "wrote $CSV"
