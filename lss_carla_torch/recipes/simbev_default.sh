#!/bin/bash
# SimBEV default training config on one GPU: configs/simbev_default.sh's
# flags, through the PyTorch/CUDA port. Every flag is ported.

DATAROOT="${DATAROOT:-/path/to/simbev/dataset}"

EPOCHS=100
BATCH_SIZE=4
NUM_WORKERS=4
LEARNING_RATE=0.001

IMAGE_H=224
IMAGE_W=480
FINAL_H=128
FINAL_W=352
NUM_CAMS=6

LOGDIR="${LOGDIR:-./runs/simbev_$(date +%Y%m%d_%H%M%S)}"

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
    --val_step 500 \
    --save_step 1000
