#!/usr/bin/env bash
# Package-install smoke of the port (bin/install-smoke.sh): install the
# package into a throwaway --prefix (offline: --no-build-isolation
# --no-deps; a regular install, not editable), run the INSTALLED
# `nbody-torch` console script with the repo off PYTHONPATH, and byte-diff
# its output against `python -m parallel_nbody_tpu_torch.cli` on the parity
# configuration, both on the CPU.  Usage: install-smoke.sh [PREFIX]
set -euo pipefail
. "$(dirname "$0")/common.sh"

WORK="$(mktemp -d)"
trap 'rm -rf "${WORK:?}"' EXIT
PFX="${1:-$WORK/prefix}"
ARENA="$(ensure_arena "$WORK/arena.ppm")"
PYDIR="$(python -c 'import sys; print("python%d.%d" % sys.version_info[:2])')"

rm -rf "${PFX:?}"
pip install -q "$REPO_ROOT" --no-build-isolation --no-deps --prefix "$PFX"
rm -rf "${REPO_ROOT:?}/build" "${REPO_ROOT:?}"/*.egg-info  # build residue

test -x "$PFX/bin/nbody-torch"

out_installed=$(cd "$WORK" && env -u PYTHONPATH \
  PYTHONPATH="$PFX/lib/$PYDIR/site-packages" NBODY_PLATFORM=cpu \
  "$PFX/bin/nbody-torch" 24 0 "$ARENA" 10 2>/dev/null)
out_module=$(cd "$WORK" && NBODY_PLATFORM=cpu \
  python -m parallel_nbody_tpu_torch.cli 24 0 "$ARENA" 10 2>/dev/null)

if [ "$out_installed" = "$out_module" ] && [ -n "$out_installed" ]; then
  echo "INSTALL_SMOKE_OK (24 bodies x 10 steps byte-identical via the installed nbody-torch)"
else
  echo "INSTALL_SMOKE_FAILED" >&2
  diff <(printf '%s\n' "$out_installed") <(printf '%s\n' "$out_module") >&2 || true
  exit 1
fi
