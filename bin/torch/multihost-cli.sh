#!/bin/bash
# Full-CLI multi-process launch of the port (bin/multihost-cli.sh): NPROCS
# processes, one gloo rank each on the CPU, join one process group through
# the JAX package's manual spelling (COORDINATOR_ADDRESS,
# NBODY_NUM_PROCESSES, NBODY_PROCESS_ID), run the complete CLI with the
# body axis sharded over them, and rank 0 prints the final state or CSV.
# Usage: multihost-cli.sh [NPROCS] [N] [STEPS] [extra flags...]
set -u -o pipefail
. "$(dirname "$0")/common.sh"

NPROCS="${1:-2}"
N="${2:-64}"
STEPS="${3:-100}"
shift $(( $# > 3 ? 3 : $# ))
PORT="${PORT:-9877}"
ARENA=$(ensure_arena)

pids=()
for PID in $(seq 0 $((NPROCS - 1))); do
  COORDINATOR_ADDRESS="localhost:$PORT" \
  NBODY_NUM_PROCESSES="$NPROCS" \
  NBODY_PROCESS_ID="$PID" \
  NBODY_PLATFORM=cpu \
  $NBODY "$N" 0 "$ARENA" "$STEPS" --devices="$NPROCS" "$@" &
  pids+=($!)
done

rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done
exit "$rc"
