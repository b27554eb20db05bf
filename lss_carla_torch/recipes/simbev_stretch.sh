#!/bin/bash
# Stretch config through the PyTorch/CUDA port: configs/simbev_stretch.sh's
# flags (400x400 BEV at 0.25 m, 4 classes, EfficientNet-B4, bf16, cosine
# with warm-up, 8 data-parallel ranks: one process a GPU, a global batch
# of 32, 4 a GPU). Every flag is ported.
# On one card: N_DEVICES=1 BATCH_SIZE=4, and add --accum_steps 2 (and
# --ema_decay 0.999 --fused_dw for the recipe chip_smoke.py drives).

DATAROOT="${DATAROOT:-/data/SimBEV}"

EPOCHS=30
BATCH_SIZE="${BATCH_SIZE:-32}"     # global batch over N_DEVICES GPUs
N_DEVICES="${N_DEVICES:-8}"
NUM_WORKERS=16
LEARNING_RATE=0.001

IMAGE_H=224
IMAGE_W=480
FINAL_H=128
FINAL_W=352
NUM_CAMS=6

LOGDIR="${LOGDIR:-./runs/simbev_stretch_$(date +%Y%m%d_%H%M%S)}"

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
    --xbound -50.0 50.0 0.25 \
    --ybound -50.0 50.0 0.25 \
    --label_mode multiclass \
    --variant b4 \
    --compute_dtype bfloat16 \
    --n_devices $N_DEVICES \
    --lr_schedule cosine \
    --warmup_steps 500 \
    --logdir "$LOGDIR" \
    --val_step 2000 \
    --save_step 2000
