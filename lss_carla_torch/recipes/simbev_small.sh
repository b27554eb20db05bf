#!/bin/bash
# SimBEV small/fast experiment config on one GPU: configs/simbev_small.sh's
# flags, through the PyTorch/CUDA port. Every flag is ported (wandb logs
# where wandb is installed, and says so where it is not).

DATAROOT="${DATAROOT:-/data/SimBEV}"

EPOCHS=30
BATCH_SIZE=8
NUM_WORKERS=8
LEARNING_RATE=0.0005

IMAGE_H=224
IMAGE_W=480
FINAL_H=128
FINAL_W=352
NUM_CAMS=6

LOGDIR="${LOGDIR:-./runs/simbev_test_$(date +%Y%m%d_%H%M%S)}"

python -m lss_carla_torch.train \
    --dataroot "$DATAROOT" \
    --nepochs $EPOCHS \
    --bsz $BATCH_SIZE \
    --nworkers $NUM_WORKERS \
    --lr $LEARNING_RATE \
    --H $IMAGE_H \
    --W $IMAGE_W \
    --final_h $FINAL_H \
    --final_w $FINAL_W \
    --ncams $NUM_CAMS \
    --logdir "$LOGDIR" \
    --val_step 8640 \
    --save_step 4320 \
    --use_wandb \
    --wandb_project SIMBEV-lift-splat-shoot \
    --wandb_name simbev_small_experiment
