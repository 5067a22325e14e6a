#!/usr/bin/env bash
# The full-digital agent's bars on one GPU, as the JAX package's r5 runner
# trains and deploys it (the c4_digital and c4_fog_v2x_digital arms of
# scripts/run_baselines.py): the c4 preset over the VQ camera and the VQ
# LiDAR, both codebooks re-seeded, the usage term on the LiDAR's alone.
#
#   bash bars/c4_digital.sh OUT_DIR [SEED]
#
# Trains c4_digital and the fogged full-digital agent with the roadside
# unit's 32 rays (env.fog_range=20 env.v2x_rays=32) side by side, 5000
# iterations each; checkpoints go under $TMPDIR. Then, side by side: each
# EMA policy's 256-episode evaluation, and c4_digital's EMA return across
# AWGN at -5..25 dB uncoded, with soft Hamming(7,4) and under Type-I HARQ
# (whose rows carry the symbols the three links really sent). Each
# command's output goes to OUT_DIR/NAME.{txt,json}; each line of the
# standard output names a command and its exit code. Read the bars with
# `python bars/digital_summary.py --c4 OUT_DIR`.
set -uo pipefail
out=${1:?usage: bash bars/c4_digital.sh OUT_DIR [SEED]}
seed=${2:-0}
ck=${TMPDIR:-/tmp}/c4_digital_bars_$seed
mkdir -p "$out" "$ck"
dg="--config c4 --set camera.arch=vq --set lidar.arch=vq
    --set camera.vq_usage_coef=0.0 --set camera.vq_reseed=0.05
    --set lidar.vq_usage_coef=0.05 --set lidar.vq_reseed=0.05
    --set train.seed=$seed"
fog="--set env.fog_range=20 --set env.v2x_rays=32"

train() {
    local name=$1
    shift
    python -m multimodal_sc_torch.train.dqn "$@" --set train.steps=5000 \
        --set train.log_every=500 --set train.checkpoint_every=5000 \
        --set "train.checkpoint_dir=$ck/$name" --eval-envs 256 \
        > "$out/$name.train.txt" 2> "$out/$name.train.err"
    echo "train $name rc=$?"
}

evaluate() {
    local name=$1 dir=$2
    shift 2
    python -m multimodal_sc_torch.evaluation.policy_eval "$@" --use-ema \
        --episodes 256 --set "train.checkpoint_dir=$ck/$dir" \
        > "$out/$name.txt" 2> "$out/$name.err"
    echo "eval $name rc=$?"
}

t0=$(date +%s)
train c4_digital $dg &
train c4_fog_v2x_digital $dg $fog &
wait
echo "trainings: $(( $(date +%s) - t0 )) s"

t0=$(date +%s)
evaluate c4_digital_eval_ema c4_digital $dg &
evaluate c4_fog_v2x_digital_eval_ema c4_fog_v2x_digital $dg $fog &
sweep="--snr-sweep --kinds awgn"
evaluate c4_digital_sweep c4_digital $dg $sweep \
    --out "$out/c4_digital_sweep.json" &
evaluate c4_digital_sweep_fec c4_digital $dg $sweep \
    --set channel.fec=hamming74_soft --out "$out/c4_digital_sweep_fec.json" &
evaluate c4_digital_sweep_harq c4_digital $dg $sweep \
    --set channel.harq=true --out "$out/c4_digital_sweep_harq.json" &
wait
echo "evaluations: $(( $(date +%s) - t0 )) s"
