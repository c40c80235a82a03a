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

# ---------------------------------------------------------------------------
# The fuzz harnesses' helpers (bin/common.sh's, for the port).  Their oracle
# is the reference binary's stdout.  The JAX repo's sweeps cached every
# output they needed as tests_out/<stream>/seq_<N>_<STEPS>.out, and those
# caches are committed, so the port reads them first (NBODY_FUZZ_ORACLE
# names the directory; it is only ever read).  An output that no cache holds
# is made by $NBODY_REF_BIN (no default: unset, such an output is missing)
# into the port's own output directory.
# ---------------------------------------------------------------------------

# The number of ranks that the flags ask for: K of --devices=K, R*C of
# --mesh2d=RxC (which wins, as in the CLI), else 1.
fuzz_ranks() {
  local ranks=1 grid="" a
  for a in "$@"; do
    case "$a" in
      --devices=*) ranks="${a#--devices=}" ;;
      --mesh2d=*) grid="${a#--mesh2d=}" ;;
    esac
  done
  [ -n "$grid" ] && ranks=$(( ${grid%[xX]*} * ${grid#*[xX]} ))
  echo "$ranks"
}

# One run of the port's CLI in float64, the only type that reaches the
# reference's bytes (the card's default is float32, so --dtype=float64 is
# always passed).  A run of several ranks is gloo processes on the CPU; a
# single rank runs on $NBODY_FUZZ_PLATFORM: cpu (the default), or cuda, the
# card, where --pallas is K1's fp64 instantiation.
#   fuzz_cli N SECS ARENA STEPS [FLAGS...]
fuzz_cli() {
  local plat=cpu
  if [ "$(fuzz_ranks "$@")" -le 1 ]; then
    plat="${NBODY_FUZZ_PLATFORM:-cpu}"
  fi
  NBODY_PLATFORM="$plat" $NBODY "$@" --dtype=float64
}

# The reference binary's output for N bodies and STEPS steps: the committed
# record in ORACLE, else the port's own cache in OUTDIR, else a run of
# REFBIN into OUTDIR that is cached only when it completes (a crashed
# oracle run must not poison reruns).  stdin comes from /dev/null so that a
# caller's `while read` config stream is never swallowed by the child.
#   fuzz_oracle REFBIN ARENA ORACLE OUTDIR N STEPS -> prints the path; rc=1
fuzz_oracle() {
  local refbin="$1" arena="$2" oracle="$3" outdir="$4" n="$5" steps="$6"
  local name="seq_${n}_${steps}.out"
  if [ -f "$oracle/$name" ]; then
    echo "$oracle/$name"
    return 0
  fi
  local ref="$outdir/$name"
  if [ ! -f "$ref" ]; then
    # The reference mmaps its PPM argument O_RDWR, hence the arena copy.
    if [ ! -x "$refbin" ] \
        || ! "$refbin" "$n" 0 "$arena" "$steps" < /dev/null 2>/dev/null \
           > "$ref.tmp" || [ ! -s "$ref.tmp" ]; then
      rm -f "$ref.tmp"
      return 1
    fi
    mv "$ref.tmp" "$ref"
  fi
  echo "$ref"
}

# Shared scaffolding of the fuzz scripts: resolve the oracle directory, the
# output directory and the binary; generate the config stream up front (a
# broken generator fails loudly, exit 1, instead of feeding the loop zero
# lines and reporting a false green); then count the oracles that the stream
# needs and no cache holds.  If any is missing and the binary is absent,
# report SKIPPED and exit 0, as bin/common.sh does; a reduced set is never
# run in silence.
#   fuzz_setup KIND COUNT SEED SUBDIR
# KIND is bin/fuzz_gen.py's stream (called unchanged: its draw order pins
# the records); SUBDIR is the JAX record directory of that stream.  Sets
# REFBIN, ORACLE (default tests_out/SUBDIR), OUT (default
# tests_out/torch_SUBDIR, or $NBODY_FUZZ_OUT) and CFGS.  An EXIT trap
# removes $CFGS and whatever paths the caller has put in FUZZ_SCRATCH.
fuzz_setup() {
  local kind="$1" count="$2" seed="$3" subdir="$4"
  REFBIN="${NBODY_REF_BIN:-}"
  ORACLE="${NBODY_FUZZ_ORACLE:-$REPO_ROOT/tests_out/$subdir}"
  OUT="${NBODY_FUZZ_OUT:-$REPO_ROOT/tests_out/torch_$subdir}"
  mkdir -p "$OUT"
  if [ -d "$ORACLE" ] && \
      [ "$(cd "$OUT" && pwd -P)" = "$(cd "$ORACLE" && pwd -P)" ]; then
    echo "REFUSED: the output directory is the oracle directory $ORACLE"
    exit 2
  fi
  CFGS="$(mktemp "${TMPDIR:-/tmp}/fuzz_${kind}_configs.XXXXXX")" || exit 1
  FUZZ_SCRATCH=()
  trap 'rm -rf "$CFGS" "${FUZZ_SCRATCH[@]}"' EXIT
  if ! python "$REPO_ROOT/bin/fuzz_gen.py" "$kind" "$seed" "$count" > "$CFGS"
  then
    echo "CONFIG GENERATION FAILED (seed=$seed count=$count)"
    exit 1
  fi
  # The (N, steps) of every oracle the stream needs: a parity line is
  # N STEPS ..., a resume line N TOTAL SPLIT ... (both legs are diffed).
  local pairs n s total=0 missing=0
  case "$kind" in
    parity|parity2) pairs="$(awk '{ print $1, $2 }' "$CFGS")" ;;
    *) pairs="$(awk '{ print $1, $3; print $1, $2 }' "$CFGS")" ;;
  esac
  while read -r n s; do
    total=$((total + 1))
    if [ ! -f "$ORACLE/seq_${n}_${s}.out" ] \
        && [ ! -f "$OUT/seq_${n}_${s}.out" ]; then
      missing=$((missing + 1))
    fi
  done < <(printf '%s\n' "$pairs" | sort -u)
  if [ "$missing" -gt 0 ] && [ ! -x "$REFBIN" ]; then
    echo "SKIPPED: reference binary not found at ${REFBIN:-(NBODY_REF_BIN unset)}" \
         "($missing of $total oracles uncached)"
    exit 0
  fi
  local arena_src
  arena_src=$(ensure_arena)
  cp "$arena_src" "$OUT/arena.ppm"
}

# Count guard shared by the fuzz loops: a partially consumed config stream
# fails the run even if every config that did run passed.
#   fuzz_check_count RAN EXPECTED   -> rc=1 + message on mismatch
fuzz_check_count() {
  if [ "$1" -ne "$2" ]; then
    echo "CONFIG COUNT MISMATCH: ran $1 of $2"
    return 1
  fi
}

# The two-leg checkpoint/resume loop of fuzz-resume.sh and fuzz-resume-v2.sh
# (both streams emit N TOTAL SPLIT FMT F1 F2).  Leg 1 runs to SPLIT under
# FLAGS1 and checkpoints; leg 2 resumes under the independently drawn
# FLAGS2 and runs to TOTAL.  Both legs' stdout must equal the reference
# binary's uninterrupted runs at SPLIT and TOTAL steps byte for byte.
# FMT=npz checkpoints to a .npz; FMT=orbax to a path without .npz, which is
# the port's directory checkpoint (torch.distributed.checkpoint, each rank
# its shard), its counterpart of the JAX package's Orbax directory.
#   fuzz_resume_loop EXPECTED_COUNT   (reads $CFGS; needs $REFBIN, $ORACLE, $OUT)
fuzz_resume_loop() {
  local expected="$1" fail=0 ran=0
  local N TOTAL SPLIT FMT FLAGS1 FLAGS2 ref_k ref_s base ck ok1 ok2
  while read -r N TOTAL SPLIT FMT FLAGS1 FLAGS2; do
    FLAGS1="${FLAGS1//|/ }"
    FLAGS2="${FLAGS2//|/ }"
    if ! ref_k=$(fuzz_oracle "$REFBIN" "$OUT/arena.ppm" "$ORACLE" "$OUT" \
                   "$N" "$SPLIT") \
        || ! ref_s=$(fuzz_oracle "$REFBIN" "$OUT/arena.ppm" "$ORACLE" \
                       "$OUT" "$N" "$TOTAL"); then
      echo "ORACLE GENERATION FAILED: N=$N steps=$SPLIT/$TOTAL"
      fail=1
      continue
    fi
    ran=$((ran + 1))
    base="$OUT/resume_${N}_${SPLIT}of${TOTAL}_${FMT}_$(
      printf '%s_%s' "$FLAGS1" "$FLAGS2" | tr ' =' '__')"
    ck="$base.ck"
    [ "$FMT" = npz ] && ck="$ck.npz"
    # Registered with the EXIT trap so that an interrupt mid-config leaves
    # no checkpoint in the record directory.
    FUZZ_SCRATCH=("$base.ck" "$base.ck.npz")
    rm -rf "$base.ck" "$base.ck.npz"

    fuzz_cli "$N" 0 "$OUT/arena.ppm" "$SPLIT" $FLAGS1 --checkpoint="$ck" \
      < /dev/null > "$base.leg1.out" 2> "$base.leg1.err"
    fuzz_cli "$N" 0 "$OUT/arena.ppm" "$TOTAL" $FLAGS2 --resume="$ck" \
      < /dev/null > "$base.out" 2> "$base.err"

    # Both diffs run unconditionally: a leg-1 mismatch must not leave a
    # stale or missing leg-2 diff behind the FAILED line.
    diff "$ref_k" "$base.leg1.out" > "$base.leg1.diff"; ok1=$?
    diff "$ref_s" "$base.out" > "$base.diff"; ok2=$?
    if [ "$ok1" -eq 0 ] && [ "$ok2" -eq 0 ]; then
      echo "STATUS=PASSED" >> "$base.out"
      echo "PASSED N=$N split=$SPLIT/$TOTAL $FMT [$FLAGS1] -> [$FLAGS2]"
    else
      # The casing of bin/tests.sh's marker, which failed-tests.sh greps.
      echo "Status=FAILED" >> "$base.out"
      echo "FAILED N=$N split=$SPLIT/$TOTAL $FMT [$FLAGS1] -> [$FLAGS2]" \
           "(see $base.diff / $base.leg1.diff)"
      fail=1
    fi
    rm -rf "$base.ck" "$base.ck.npz"  # checkpoints are reproducible
    FUZZ_SCRATCH=()
  done < "$CFGS"

  fuzz_check_count "$ran" "$expected" || fail=1
  return "$fail"
}
