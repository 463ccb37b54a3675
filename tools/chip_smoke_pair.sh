#!/bin/bash
# Time whole chip_smoke.py runs of several checkouts on one host.
#
#   tools/chip_smoke_pair.sh OUT DIR [DIR ...]
#
# Runs `python3 chip_smoke.py` from each DIR (a checkout unpacked with
# `git archive`, e.g. the change and its parent), one after the other,
# each under a 1150 s limit. Each run's standard output and errors go to
# OUT/<basename of DIR>.out and .err; OUT/host.txt gets the card's name
# and power limit, the CPU and the versions, then each run's exit code
# and wall seconds, which are also printed with the run's "[time]" lines.
set -u
out=$(realpath -m "$1"); shift
mkdir -p "$out"
{ nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  grep -m1 "model name" /proc/cpuinfo; nproc
  python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'; } > "$out/host.txt" 2>&1
for dir in "$@"; do
  name=$(basename "$dir")
  t0=$(date +%s.%N)
  (cd "$dir" && timeout -k 10 1150 python3 chip_smoke.py > "$out/$name.out" 2> "$out/$name.err")
  rc=$?
  t1=$(date +%s.%N)
  echo "$name rc $rc seconds $(python3 -c "print(round($t1 - $t0, 1))")" | tee -a "$out/host.txt"
done
cat "$out/host.txt"
for dir in "$@"; do
  name=$(basename "$dir")
  echo "== $name"
  grep -aE "^\[time\]|CPU halves done|\[build\] seconds|^\{\"ok\"" "$out/$name.out" "$out/$name.err" | cut -c1-300
  tail -c 1500 "$out/$name.err"
done
