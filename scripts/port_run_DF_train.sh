#!/usr/bin/env bash
# The PyTorch port's DeepFashion 256x256 training pipeline, on the card:
# the steps and flags of scripts/run_DF_train.sh through python -m
# dpig_tpu_torch.main (models 101 -> 102 -> 103 -> 104).
#
#   scripts/port_run_DF_train.sh <data_dir> [log_dir] [tf1_prefix]
#
# With a TF1 checkpoint prefix (the paper's published DeepFashion
# checkpoint) nothing is trained: the checkpoint is imported once without
# TensorFlow (python -m dpig_tpu_torch.train.tf1_import) into
# <log_dir>/df_tf1, and each stage's model_dir gets ckpt/step_00000000
# linked to it, where scripts/port_run_DF_test.sh looks up the four
# --pretrained_* paths.
set -euo pipefail
DATA_DIR=${1:?usage: port_run_DF_train.sh <data_dir> [log_dir] [tf1_prefix]}
LOG_DIR=${2:-logs}
TF1=${3:-}
DATASET=DF_train_data

if [ -n "$TF1" ]; then
    python -m dpig_tpu_torch.train.tf1_import --ckpt_path="$TF1" \
        --img_H=256 --img_W=256 --model_dir="$LOG_DIR/df_tf1"
    for stage in df_stage1 df_poseae df_appsample df_posesample; do
        mkdir -p "$LOG_DIR/$stage/ckpt"
        ln -sfn "$(cd "$LOG_DIR/df_tf1/ckpt" && pwd)/step_00000000" \
            "$LOG_DIR/$stage/ckpt/step_00000000"
    done
    exit 0
fi

common=(--dataset="$DATASET" --data_dir="$DATA_DIR" --log_dir="$LOG_DIR"
        --img_H=256 --img_W=256)

# Stage-I appearance (ref: bs6, 120k steps)
python -m dpig_tpu_torch.main --model=101 "${common[@]}" --batch_size=6 \
    --g_lr=2e-5 --d_lr=2e-5 --max_step=120000 --lr_update_step=50000 \
    --model_dir="$LOG_DIR/df_stage1"

# Pose AE (ref: bs16, 120k)
python -m dpig_tpu_torch.main --model=102 "${common[@]}" --batch_size=16 \
    --g_lr=2e-5 --max_step=120000 --lr_update_step=50000 \
    --model_dir="$LOG_DIR/df_poseae"

# App sampler — single 7*32-d mapper (ref: bs16, 120k)
python -m dpig_tpu_torch.main --model=103 "${common[@]}" --batch_size=16 \
    --g_lr=2e-5 --d_lr=2e-5 --max_step=120000 --lr_update_step=50000 \
    --pretrained_path="$(ls -d "$LOG_DIR"/df_stage1/ckpt/step_* | tail -1)" \
    --model_dir="$LOG_DIR/df_appsample"

# Pose sampler (ref: bs32, 60k)
python -m dpig_tpu_torch.main --model=104 "${common[@]}" --batch_size=32 \
    --g_lr=2e-5 --d_lr=2e-5 --max_step=60000 --lr_update_step=50000 \
    --pretrained_path="$(ls -d "$LOG_DIR"/df_stage1/ckpt/step_* | tail -1)" \
    --pretrained_poseAE_path="$(ls -d "$LOG_DIR"/df_poseae/ckpt/step_* | tail -1)" \
    --model_dir="$LOG_DIR/df_posesample"
