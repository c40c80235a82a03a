#!/bin/bash
# Multi-rank smoke of the port (bin/multihost-smoke.sh): NPROCS gloo ranks
# on the CPU run the real distributed programs and check every rank against
# the single-rank run (python -m parallel_nbody_tpu_torch.parallel.dryrun,
# the counterpart of multihost_smoke; it spawns the ranks itself).
# Usage: multihost-smoke.sh [NPROCS] [STEPS]
set -u
. "$(dirname "$0")/common.sh"

NPROCS="${1:-2}"
STEPS="${2:-3}"

if python -m parallel_nbody_tpu_torch.parallel.dryrun "$NPROCS" "$STEPS"; then
  echo "multihost smoke: ALL $NPROCS PROCESSES OK"
else
  echo "multihost smoke: FAILED" >&2
  exit 1
fi
