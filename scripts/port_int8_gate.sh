#!/usr/bin/env bash
# The PyTorch port's int8 quality gate at depth, on the card: Stage I
# trained from a seed (python -m dpig_tpu_torch.eval.int8_quality train:
# Market 128x64 at bs64, and --size=256, the model-101 shape, at bs16;
# synthetic batches), then at each depth the six-scheme sweep, the gate,
# and at Market check --per_layer, check --transfer and gate --transfer.
# Each depth resumes the checkpoints of the one before it.
#
#   scripts/port_int8_gate.sh <log_dir> <ckpt_dir> [market depths] \
#       [256 depths]
#   e.g. scripts/port_int8_gate.sh logs/gate logs/gate_ckpt "2000 10000" \
#       "2000 6000"
#
# Writes <log_dir>/<size>_<steps>.log per depth; the checkpoints go under
# <ckpt_dir>/market and <ckpt_dir>/df256 (gigabytes: keep them out of git).
set -u
out=${1:?log_dir}
ck=${2:?ckpt_dir}
market=${3:-2000}
df=${4:-2000}
mkdir -p "$out" "$ck"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
q="python -m dpig_tpu_torch.eval.int8_quality"
for s in $market; do
  log="$out/market_$s.log"
  {
    $q train "$s" "$ck/market"
    $q sweep "$ck/market"
    $q gate "$ck/market"; echo "gate_rc=$?"
    $q check "$ck/market" --per_layer
    $q check "$ck/market" --transfer
    $q gate "$ck/market" --transfer; echo "gate_transfer_rc=$?"
  } > "$log" 2>&1
  grep -E "img/s|^[a-z(-].* +[0-9.]+ +[-+][0-9.]+$|PASS|FAIL|gate_|rel.err|^    " "$log" | tail -40
done
for s in $df; do
  log="$out/df256_$s.log"
  {
    $q train "$s" "$ck/df256" --size=256 --pool=32
    $q sweep "$ck/df256" --size=256
    $q gate "$ck/df256" --size=256; echo "gate_rc=$?"
    $q check "$ck/df256" --size=256 --per_layer
  } > "$log" 2>&1
  grep -E "img/s|^[a-z(-].* +[0-9.]+ +[-+][0-9.]+$|PASS|FAIL|gate_|^    " "$log" | tail -40
done
