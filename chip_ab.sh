#!/usr/bin/env bash
# Compare two trees of this repo on one NVIDIA card, in turns A, B, B, A:
# first chip_smoke.py from each tree (the four turns twice, for more
# readings of the host-bound event times), then profile_port.py from each.
# Each tree builds its own kernels under its own build/.
#
# The trees are made before the call, from git, into a directory that
# .gitignore lists; for the last commit against the working tree:
#
#   rm -rf build/ab && mkdir -p build/ab/parent build/ab/change
#   git archive HEAD | tar -x -C build/ab/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C build/ab/change
#   bash chip_ab.sh build/ab/parent build/ab/change [LOG_DIR]
#
# Each run's whole output goes to LOG_DIR/<run>.log (default build/ab/logs);
# stdout gets each run's exit code and its last lines (the kernels' JSON line
# of chip_smoke.py, the stage times of profile_port.py).  Exits nonzero if
# any run failed.
set -u
if [ $# -lt 2 ] || [ $# -gt 3 ]; then
  echo "usage: bash chip_ab.sh TREE_A TREE_B [LOG_DIR]" >&2
  exit 2
fi
a=$(realpath "$1")
b=$(realpath "$2")
out=$(realpath -m "${3:-build/ab/logs}")
mkdir -p "$out"
rc=0

run() {  # run LABEL TREE SCRIPT LINES
  local t0=$SECONDS
  (cd "$2" && python3 "$3") >"$out/$1.log" 2>&1
  local r=$?
  echo "== $1: $3 in $2: rc $r, $((SECONDS - t0)) s"
  tail -n "$4" "$out/$1.log"
  [ $r -eq 0 ] || rc=1
}

for i in 1 2; do
  run "smoke_${i}_1_A" "$a" chip_smoke.py 4
  run "smoke_${i}_2_B" "$b" chip_smoke.py 4
  run "smoke_${i}_3_B" "$b" chip_smoke.py 4
  run "smoke_${i}_4_A" "$a" chip_smoke.py 4
done
run profile_1_A "$a" profile_port.py 0
run profile_2_B "$b" profile_port.py 0
run profile_3_B "$b" profile_port.py 0
run profile_4_A "$a" profile_port.py 0
for f in "$out"/profile_*.log; do
  echo "== $(basename "$f" .log): stage times"
  grep -E -- '^(encode|decode|--- profile)' "$f"
done
exit $rc
