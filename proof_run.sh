#!/usr/bin/env bash
# The proof run of a change on one NVIDIA card: chip_smoke.py from two
# unpacked trees in turns (parent, change, change, parent), the port's GPU
# tests in the change's tree, then the change's chip_smoke.py alone in an
# empty directory. Alone it must fail: with no tensorrtx_tpu_torch beside
# it, its import of the package raises (ModuleNotFoundError, exit 1).
#
#   bash proof_run.sh PARENT_DIR CHANGE_DIR OUT_DIR
#
# Writes OUT_DIR/{p1,c1,c2,p2}.{log,err}, gpu_tests.log and alone.err, and
# prints one line per step: exit code, seconds and the last line of output.
# Exits non-zero if a chip_smoke.py run or the tests fail, or if the script
# alone exits 0 or fails for another reason than the missing package.
set -u
parent=$(realpath "$1") change=$(realpath "$2") out=$(realpath -m "$3")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit,clocks.sm,clocks.mem --format=csv,noheader
status=0
for run in p1 c1 c2 p2; do
    case $run in p*) tree=$parent ;; *) tree=$change ;; esac
    t0=$(date +%s)
    (cd "$tree" && timeout 1200 python3 chip_smoke.py >"$out/$run.log" 2>"$out/$run.err")
    rc=$?
    echo "$run rc=$rc seconds=$(($(date +%s) - t0)) last=$(tail -n 1 "$out/$run.log")"
    [ $rc -eq 0 ] || status=1
done
(cd "$change" && timeout 1500 python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py \
    >"$out/gpu_tests.log" 2>&1)
rc=$?
echo "gpu tests rc=$rc $(tail -n 1 "$out/gpu_tests.log")"
[ $rc -eq 0 ] || status=1
alone=$(mktemp -d)
cp "$change/chip_smoke.py" "$alone/"
(cd "$alone" && timeout 300 python3 chip_smoke.py >"$out/alone.log" 2>"$out/alone.err")
rc=$?
rm -rf "$alone"
echo "alone rc=$rc (must fail: no package beside it) $(tail -n 1 "$out/alone.err")"
if [ $rc -eq 0 ] || [ -s "$out/alone.log" ] \
    || ! grep -q "No module named 'tensorrtx_tpu_torch'" "$out/alone.err"; then
    status=1
fi
exit $status
