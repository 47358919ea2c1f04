#!/usr/bin/env bash
# The PyTorch port's DeepFashion inference and scoring, on the card: the
# steps, flags and ckpt/step_* lookups of scripts/run_DF_test.sh through
# python -m dpig_tpu_torch.main and python -m dpig_tpu_torch.eval.score
# (no Inception score: the port has no classifier yet).
#
#   scripts/port_run_DF_test.sh <data_dir> <log_dir>
#
# <log_dir> holds the four stages' model_dirs, trained or linked to an
# imported TF1 checkpoint by scripts/port_run_DF_train.sh.
set -euo pipefail
DATA_DIR=${1:?usage: port_run_DF_test.sh <data_dir> <log_dir>}
LOG_DIR=${2:?}
DATASET=DF_test_data

stage1=$(ls -d "$LOG_DIR"/df_stage1/ckpt/step_* | tail -1)
poseae=$(ls -d "$LOG_DIR"/df_poseae/ckpt/step_* | tail -1)
appsample=$(ls -d "$LOG_DIR"/df_appsample/ckpt/step_* | tail -1)
posesample=$(ls -d "$LOG_DIR"/df_posesample/ckpt/step_* | tail -1)

common=(--dataset="$DATASET" --data_dir="$DATA_DIR" --is_train=false
        --img_H=256 --img_W=256 --batch_size=16
        --pretrained_path="$stage1" --pretrained_poseAE_path="$poseae"
        --pretrained_appSample_path="$appsample"
        --pretrained_poseSample_path="$posesample")

# 1001: conditional pose transfer (ref: 400x16)
python -m dpig_tpu_torch.main --model=1001 "${common[@]}" --model_dir="$LOG_DIR/df_test1001"
python -m dpig_tpu_torch.eval.score 1 "$LOG_DIR/df_test1001" test_result
python -m dpig_tpu_torch.eval.score 1 "$LOG_DIR/df_test1001" test_result --mask

# 1002: appearance/pose factor sampling (ref: 100x16)
python -m dpig_tpu_torch.main --model=1002 "${common[@]}" --sample_fg=true \
    --test_batch_num=100 --model_dir="$LOG_DIR/df_test1002"
