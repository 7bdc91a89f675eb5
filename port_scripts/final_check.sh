#!/bin/sh
# The card checks of one checkout of the port, on a machine with one CUDA card:
#
#   sh port_scripts/final_check.sh CHECKOUT_DIR LOG_DIR
#
# CHECKOUT_DIR holds the files of the commit to check and nothing built (for
# example `git archive` of it, unpacked into a git-ignored directory). Runs
#   1. chip_smoke.py from CHECKOUT_DIR (it builds the kernels from there),
#   2. the card tests: pytest --noconftest -m requires_cuda tests/test_torch_port_cuda.py,
#   3. chip_smoke.py alone in an otherwise empty directory, which must fail.
# Prints each exit code, the seconds each took and the last lines of each
# log; the whole logs go to LOG_DIR. Exits 0 only if 1 and 2 pass and 3 fails.
set -u
src=$(cd "${1:?usage: final_check.sh CHECKOUT_DIR LOG_DIR}" && pwd)
logs=${2:?usage: final_check.sh CHECKOUT_DIR LOG_DIR}
mkdir -p "$logs"
logs=$(cd "$logs" && pwd)

t0=$(date +%s)
(cd "$src" && python3 chip_smoke.py) > "$logs/final_smoke.log" 2>&1
smoke_rc=$?
echo "smoke_rc=$smoke_rc seconds=$(( $(date +%s) - t0 ))"
tail -n 3 "$logs/final_smoke.log"

t0=$(date +%s)
(cd "$src" && python3 -m pytest --noconftest -m requires_cuda tests/test_torch_port_cuda.py -q) \
    > "$logs/final_cuda_tests.log" 2>&1
tests_rc=$?
echo "cuda_tests_rc=$tests_rc seconds=$(( $(date +%s) - t0 ))"
tail -n 3 "$logs/final_cuda_tests.log"

alone="$logs/alone"
rm -rf "$alone"
mkdir -p "$alone"
cp "$src/chip_smoke.py" "$alone/"
(cd "$alone" && python3 chip_smoke.py) > "$logs/final_alone.log" 2>&1
alone_rc=$?
rm -rf "$alone"
echo "alone_rc=$alone_rc"

[ "$smoke_rc" -eq 0 ] && [ "$tests_rc" -eq 0 ] && [ "$alone_rc" -ne 0 ]
