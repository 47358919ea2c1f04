#!/usr/bin/env bash
# The PyTorch port's Market-1501 training pipeline, on the card: the steps
# and flags of scripts/run_market_train.sh through python -m
# dpig_tpu_torch.main (Stage-I appearance -> pose AE -> Stage-II app
# samplers -> pose sampler).
#
#   scripts/port_run_market_train.sh <data_dir> [log_dir] [tf1_prefix]
#
# With a TF1 checkpoint prefix (the paper's published Market checkpoint)
# nothing is trained: the checkpoint is imported once without TensorFlow
# (python -m dpig_tpu_torch.train.tf1_import) into <log_dir>/market_tf1,
# and each stage's model_dir gets ckpt/step_00000000 linked to it, where
# scripts/port_run_market_test.sh looks up the four --pretrained_* paths.
set -euo pipefail
DATA_DIR=${1:?usage: port_run_market_train.sh <data_dir> [log_dir] [tf1_prefix]}
LOG_DIR=${2:-logs}
TF1=${3:-}
DATASET=Market_train_data

if [ -n "$TF1" ]; then
    python -m dpig_tpu_torch.train.tf1_import --ckpt_path="$TF1" \
        --img_H=128 --img_W=64 --model_dir="$LOG_DIR/market_tf1"
    for stage in market_stage1 market_poseae market_appsample \
                 market_posesample; do
        mkdir -p "$LOG_DIR/$stage/ckpt"
        ln -sfn "$(cd "$LOG_DIR/market_tf1/ckpt" && pwd)/step_00000000" \
            "$LOG_DIR/$stage/ckpt/step_00000000"
    done
    exit 0
fi

common=(--dataset="$DATASET" --data_dir="$DATA_DIR" --log_dir="$LOG_DIR"
        --img_H=128 --img_W=64)

# Stage-I appearance reconstruction (ref: bs16, 120k steps, lr 2e-5/50k)
python -m dpig_tpu_torch.main --model=1 "${common[@]}" --batch_size=16 \
    --g_lr=2e-5 --d_lr=2e-5 --max_step=120000 --lr_update_step=50000 \
    --model_dir="$LOG_DIR/market_stage1"

# Stage-I pose autoencoder (ref: bs64, 60k steps)
python -m dpig_tpu_torch.main --model=2 "${common[@]}" --batch_size=64 \
    --g_lr=2e-5 --max_step=60000 --lr_update_step=50000 \
    --model_dir="$LOG_DIR/market_poseae"

# Stage-II appearance samplers (ref: bs32, 120k steps, WGAN critic x5)
python -m dpig_tpu_torch.main --model=3 "${common[@]}" --batch_size=32 \
    --g_lr=2e-5 --d_lr=2e-5 --max_step=120000 --lr_update_step=50000 \
    --pretrained_path="$(ls -d "$LOG_DIR"/market_stage1/ckpt/step_* | tail -1)" \
    --model_dir="$LOG_DIR/market_appsample"

# Stage-II pose sampler (ref: bs64, 60k steps, WGAN)
python -m dpig_tpu_torch.main --model=4 "${common[@]}" --batch_size=64 \
    --g_lr=2e-5 --d_lr=2e-5 --max_step=60000 --lr_update_step=50000 \
    --pretrained_path="$(ls -d "$LOG_DIR"/market_stage1/ckpt/step_* | tail -1)" \
    --pretrained_poseAE_path="$(ls -d "$LOG_DIR"/market_poseae/ckpt/step_* | tail -1)" \
    --model_dir="$LOG_DIR/market_posesample"
