#!/bin/bash
# SimBEV fast recipe on one GPU: configs/simbev_fast.sh's flags, through
# the PyTorch/CUDA port (bsz 8, bf16, cosine with 500 warm-up steps over
# 4,000 steps, the scale-robust --resize_lim). Every flag is ported.
# `python -m lss_carla_torch.accuracy` runs exactly these settings on the
# docs/ACCURACY.md fixture and holds the best val IoU against the JAX
# package's band.

DATAROOT="${DATAROOT:-/path/to/simbev/dataset}"
LOGDIR="${LOGDIR:-./runs/simbev_fast_$(date +%Y%m%d_%H%M%S)}"

MAX_STEPS=4000

python -m lss_carla_torch.train \
    --dataroot "$DATAROOT" \
    --bsz 8 \
    --nworkers 4 \
    --compute_dtype bfloat16 \
    --resize_lim 0.70 0.85 \
    --lr_schedule cosine \
    --warmup_steps 500 \
    --decay_steps $MAX_STEPS \
    --max_steps $MAX_STEPS \
    --logdir "$LOGDIR" \
    --val_step 500 \
    --save_step 1000
