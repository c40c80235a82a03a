#!/bin/bash
# Randomized checkpoint/resume differential fuzz of the port
# (bin/fuzz-resume.sh): leg 1 runs k steps under one drawn sharding and
# checkpoints (a .npz, or a directory: the port's counterpart of an Orbax
# directory); leg 2 resumes under an independently drawn sharding and runs
# to S steps.  Both legs' stdout must equal the reference binary's
# uninterrupted runs at k and S steps, so the state must survive the save,
# the restore, the re-sharding and the step accounting exactly.  The loop
# is fuzz_resume_loop in bin/torch/common.sh.
#
#   fuzz-resume.sh [COUNT] [SEED]     (defaults: 5 configs, seed 20260818)
#
# The oracle: $NBODY_FUZZ_ORACLE (default tests_out/fuzz_resume, only
# read), else $NBODY_REF_BIN's run into the output directory; SKIPPED and
# exit 0 when an oracle is missing and the binary is absent.  Results go to
# $NBODY_FUZZ_OUT (default tests_out/torch_fuzz_resume).
set -u
. "$(dirname "$0")/common.sh"

COUNT="${1:-5}"
SEED="${2:-20260818}"
fuzz_setup resume "$COUNT" "$SEED" fuzz_resume   # sets REFBIN, ORACLE, OUT, CFGS

fuzz_resume_loop "$COUNT"
exit "$?"
