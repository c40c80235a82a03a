#!/bin/bash
# Renderer parity of the port against the reference binary's own frames
# (bin/render-parity.sh).  The reference renders a frame whenever more
# whole seconds than secs_per_update have passed (nbody-seq.c:466-471), and
# display() writes every pixel (nbody-seq.c:327-355), so its final PPM is
# the render of the last state that drew a frame.  At N=10000 a step takes
# seconds on a CPU, so with secs_per_update=1 every step draws one, the
# last included: the final PPM is render(state after STEPS steps), and the
# port's, drawn by the CLI in float64 and written through the native blit,
# must equal it byte for byte, and so must the printout.
#
#   render-parity.sh [STEPS] [FLAGS...]   (default: 3 steps, one rank;
#                                          --devices=4 or --mesh2d=2x4 run
#                                          gloo ranks on the CPU, and rank 0
#                                          draws from the gathered state)
#
# The oracle: $NBODY_RENDER_ORACLE/ref_<tag>.{ppm,out,err} (default
# tests_out/render_parity, the reference binary's committed frames and
# printouts; only read), else $NBODY_REF_BIN's run (no default) into the
# output directory; SKIPPED and exit 0 when neither is there.  Results go to
# $NBODY_RENDER_OUT (default tests_out/torch_render_parity): ours_<tag>.
# {ppm,out,err}, frames_<tag>.log (one line per frame drawn, the CLI's
# NBODY_FRAME_LOG), stdout_<tag>.diff and STATUS_<tag>.  The arena is a
# 128x96 P6, so the reference's O(pixels x bodies) rasterizer stays a
# fraction of its step.
set -u
. "$(dirname "$0")/common.sh"

STEPS="${1:-3}"
case "$STEPS" in
  ''|*[!0-9]*|0)
    # A flags-only invocation must not become a 0-step run recorded as
    # PASSED.
    echo "usage: render-parity.sh [STEPS >= 1] [FLAGS...] (got STEPS='$STEPS')"
    exit 2 ;;
esac
[ "$#" -gt 0 ] && shift
FLAGS=("$@")
N=10000
REFBIN="${NBODY_REF_BIN:-}"
ORACLE="${NBODY_RENDER_ORACLE:-$REPO_ROOT/tests_out/render_parity}"
OUT="${NBODY_RENDER_OUT:-$REPO_ROOT/tests_out/torch_render_parity}"
mkdir -p "$OUT"
if [ -d "$ORACLE" ] && \
    [ "$(cd "$OUT" && pwd -P)" = "$(cd "$ORACLE" && pwd -P)" ]; then
  echo "REFUSED: the output directory is the oracle directory $ORACLE"
  exit 2
fi

TAG="s${STEPS}$(printf '%s' "${FLAGS[*]:-}" | tr -d ' ' | tr '=-' '__')"
REF="$ORACLE/ref_$TAG"
if [ ! -f "$REF.ppm" ] || [ ! -f "$REF.out" ] || [ ! -f "$REF.err" ]; then
  REF="$OUT/ref_$TAG"
  if [ ! -f "$REF.ppm" ] || [ ! -f "$REF.out" ] || [ ! -f "$REF.err" ]; then
    if [ ! -x "$REFBIN" ]; then
      echo "SKIPPED: reference binary not found at ${REFBIN:-(NBODY_REF_BIN unset)} (no ref_$TAG in $ORACLE)"
      exit 0
    fi
    python - "$REF.ppm" <<'PY' || exit 1
import sys
from parallel_nbody_tpu_torch.utils import ppm
ppm.create(sys.argv[1], 128, 96)
PY
    "$REFBIN" "$N" 1 "$REF.ppm" "$STEPS" > "$REF.out" 2> "$REF.err" \
      || { rm -f "$REF".*; echo "REFERENCE RUN FAILED"; exit 1; }
  fi
fi

# An early exit below must not leave a stale PASSED beside fresh results.
echo "STATUS=FAILED" > "$OUT/STATUS_$TAG"
python - "$OUT/ours_$TAG.ppm" <<'PY' || exit 1
import sys
from parallel_nbody_tpu_torch.utils import ppm
ppm.create(sys.argv[1], 128, 96)
PY
rm -f "$OUT/frames_$TAG.log"
NBODY_FRAME_LOG="$OUT/frames_$TAG.log" \
  fuzz_cli "$N" 1 "$OUT/ours_$TAG.ppm" "$STEPS" ${FLAGS[@]+"${FLAGS[@]}"} \
  > "$OUT/ours_$TAG.out" 2> "$OUT/ours_$TAG.err" \
  || { echo "ENGINE RUN FAILED (see $OUT/ours_$TAG.err)"; exit 1; }

# The premise before the byte comparison.  The reference checks the clock
# in whole seconds, so each of its steps must take about 2 s or more (its
# own timing line says so).  The port's CLI logs every frame it draws: one
# a step means the last step drew one, so its PPM is the final state's.
# Where either does not hold the comparison is inconclusive, not failed.
ref_t=$(sed -n 's/.*N-body took: \([0-9.]*\) seconds.*/\1/p' "$REF.err")
frames=$(wc -l < "$OUT/frames_$TAG.log" 2>/dev/null || echo 0)
if [ -z "$ref_t" ] || [ "$frames" -ne "$STEPS" ] || \
   ! awk -v r="$ref_t" -v s="$STEPS" 'BEGIN { exit !(r / s >= 2.0) }'; then
  echo "SKIPPED: cadence premise unmet (reference ${ref_t:-?} s for $STEPS steps, need >= 2 s/step; port drew $frames frames, need $STEPS)"
  echo "STATUS=SKIPPED" > "$OUT/STATUS_$TAG"
  exit 0
fi

fail=0
if cmp -s "$REF.ppm" "$OUT/ours_$TAG.ppm"; then
  echo "PASSED ppm N=$N steps=$STEPS ${FLAGS[*]:-} ($(md5sum < "$REF.ppm" | cut -d' ' -f1))"
else
  echo "FAILED ppm: rendered frames differ (cmp $REF.ppm $OUT/ours_$TAG.ppm)"
  fail=1
fi
if diff "$REF.out" "$OUT/ours_$TAG.out" > "$OUT/stdout_$TAG.diff"; then
  echo "PASSED stdout"
else
  echo "FAILED stdout (see $OUT/stdout_$TAG.diff)"
  fail=1
fi
if [ "$fail" -eq 0 ]; then
  echo "STATUS=PASSED" > "$OUT/STATUS_$TAG"
else
  echo "STATUS=FAILED" > "$OUT/STATUS_$TAG"
fi
exit "$fail"
