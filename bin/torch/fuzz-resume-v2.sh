#!/bin/bash
# Checkpoint/resume differential fuzz of the port, kernel axis
# (bin/fuzz-resume-v2.sh): the resume2 stream draws a force path (trig,
# --fast or --pallas) for each leg on top of its sharding, so a checkpoint
# written under one kernel is resumed under another.  A checkpoint must be
# state that no kernel owns, and every cross-kernel hand-off must still
# equal the reference binary's uninterrupted runs at both step counts.  The
# loop is fuzz_resume_loop in bin/torch/common.sh.
#
#   fuzz-resume-v2.sh [COUNT] [SEED]  (defaults: 5 configs, seed 20260818)
#
# The oracle: $NBODY_FUZZ_ORACLE (default tests_out/fuzz_resume_v2, only
# read), else $NBODY_REF_BIN's run into the output directory; SKIPPED and
# exit 0 when an oracle is missing and the binary is absent.  Results go to
# $NBODY_FUZZ_OUT (default tests_out/torch_fuzz_resume_v2).
set -u
. "$(dirname "$0")/common.sh"

COUNT="${1:-5}"
SEED="${2:-20260818}"
fuzz_setup resume2 "$COUNT" "$SEED" fuzz_resume_v2   # sets REFBIN, ORACLE, OUT, CFGS

fuzz_resume_loop "$COUNT"
exit "$?"
