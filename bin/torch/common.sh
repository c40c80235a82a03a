# Shared harness helpers of the port's scripts (sourced by bin/torch/*):
# bin/common.sh for python -m parallel_nbody_tpu_torch.cli.
# A run of one rank is on the card unless NBODY_PLATFORM=cpu (the CLI's own
# rule).  A run of more than one rank asks for the CPU explicitly: its ranks
# are gloo processes, as bin/common.sh runs every rank on the CPU, because
# one card holds one NCCL rank.  There is no XLA flag to set.

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"

NBODY="python -m parallel_nbody_tpu_torch.cli"

# The platform of a run of NP ranks: the CPU for more than one rank, else
# NBODY_PLATFORM (unset: the card).
nbody_platform() {
  if [ "${1:-1}" -gt 1 ]; then
    echo cpu
  else
    echo "${NBODY_PLATFORM:-cuda}"
  fi
}

# The port's CLI on the CPU (gloo ranks for --devices=K).
nbody_cpu() {
  NBODY_PLATFORM=cpu $NBODY "$@"
}

# Ensure an arena PPM exists (the reference ships a GIMP-made 1024x768 P6;
# we generate ours).  Status goes to stderr: callers capture this
# function's stdout as the arena path.
ensure_arena() {
  local path="${1:-$REPO_ROOT/nbody.ppm}"
  if [ ! -f "$path" ]; then
    python -c "
import sys
from parallel_nbody_tpu_torch.utils import ppm
ppm.create(sys.argv[1], 1024, 768)
" "$path" >&2
    echo "created $path (P6 1024x768)" >&2
  fi
  echo "$path"
}
