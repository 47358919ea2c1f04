#!/usr/bin/env bash
# The PyTorch port's Market-1501 inference and scoring, on the card: the
# steps, flags and ckpt/step_* lookups of scripts/run_market_test.sh through
# python -m dpig_tpu_torch.main and python -m dpig_tpu_torch.eval.score
# (no Inception score: the port has no classifier yet).
#
#   scripts/port_run_market_test.sh <data_dir> <log_dir>
#
# <log_dir> holds the four stages' model_dirs, trained or linked to an
# imported TF1 checkpoint by scripts/port_run_market_train.sh.
set -euo pipefail
DATA_DIR=${1:?usage: port_run_market_test.sh <data_dir> <log_dir>}
LOG_DIR=${2:?}

# trainAStest: symlink the train shards under a test-named dataset so the
# samplers (11/13) generate over the train identities (reference re-id use)
if [ -d "$DATA_DIR/Market_train_data" ] \
   && [ ! -d "$DATA_DIR/Market_trainAStest_data" ]; then
    mkdir "$DATA_DIR/Market_trainAStest_data"
    (cd "$DATA_DIR/Market_trainAStest_data" \
     && ln -s ../Market_train_data/* . \
     && for file in *train*; do mv "$file" "${file/train/test}"; done)
fi

stage1=$(ls -d "$LOG_DIR"/market_stage1/ckpt/step_* | tail -1)
poseae=$(ls -d "$LOG_DIR"/market_poseae/ckpt/step_* | tail -1)
appsample=$(ls -d "$LOG_DIR"/market_appsample/ckpt/step_* | tail -1)
posesample=$(ls -d "$LOG_DIR"/market_posesample/ckpt/step_* | tail -1)

common=(--data_dir="$DATA_DIR" --is_train=false
        --img_H=128 --img_W=64 --batch_size=32
        --pretrained_path="$stage1" --pretrained_poseAE_path="$poseae"
        --pretrained_appSample_path="$appsample"
        --pretrained_poseSample_path="$posesample")

# Model 11: virtual person sampling for re-id data (ref: trainAStest,
# sample_app + one_app_per_batch, sample_pose=False)
python -m dpig_tpu_torch.main --model=11 "${common[@]}" --dataset=Market_trainAStest_data \
    --sample_app=true --one_app_per_batch=true \
    --model_dir="$LOG_DIR/market_test11"

# Model 13: sample ALL factors (ref: sample_fg + sample_bg + sample_pose)
python -m dpig_tpu_torch.main --model=13 "${common[@]}" --dataset=Market_trainAStest_data \
    --sample_fg=true --sample_bg=true --sample_pose=true \
    --model_dir="$LOG_DIR/market_test13"

# Model 12: conditional pose transfer (PG2 task) on the REAL test split
python -m dpig_tpu_torch.main --model=12 "${common[@]}" --dataset=Market_test_data \
    --model_dir="$LOG_DIR/market_test12"
python -m dpig_tpu_torch.eval.score 1 "$LOG_DIR/market_test12" test_result
python -m dpig_tpu_torch.eval.score 1 "$LOG_DIR/market_test12" test_result --mask
