#!/usr/bin/env bash
# The quality recipes of the port's digital links on one GPU, as the JAX
# package's r5 runner trains and sweeps them: the trainings side by side,
# then every sweep of their checkpoints side by side.
#
#   bash bars/digital.sh OUT_DIR [SEED]
#
# Trains c3 (the analog LiDAR codec: the ceiling the digital one is held
# to), c3_vq and c3_vq_prune (2500 steps at batch 32), c1_vq and
# c1_vq_prune (3000 steps); checkpoints go under $TMPDIR. Sweeps: c3 and
# c3_vq over AWGN and Rayleigh (c3_vq uncoded and under soft and hard
# Hamming(7,4)), c3_vq's entropy-coded transport, the BEV keep sweep of
# c3_vq_prune, the camera keep sweep of c1_vq_prune, and c1_vq uniform and
# under UEP (alpha 0.25, water-filling; uncoded and soft-coded). Each
# command's JSON or table goes to OUT_DIR/NAME.{json,txt}; each line of the
# standard output names a command and its exit code.
set -uo pipefail
out=${1:?usage: bash bars/digital.sh OUT_DIR [SEED]}
seed=${2:-0}
ck=${TMPDIR:-/tmp}/digital_bars_$seed
mkdir -p "$out" "$ck"
c3vq="--set lidar.arch=vq --set lidar.vq_usage_coef=0.25 --set lidar.vq_reseed=0.05"
c3r="--set train.batch_size=32 --set train.seed=$seed"
c1vq="--set camera.arch=vq --set train.seed=$seed"

train() {
    local name=$1
    shift
    python -m "multimodal_sc_torch.train.$@" --set "train.checkpoint_dir=$ck/$name" \
        > "$out/$name.train.txt" 2> "$out/$name.train.err"
    echo "train $name rc=$?"
}

sweep() {
    local name=$1 dir=$2
    shift 2
    python -m multimodal_sc_torch.evaluation.snr_sweep "$@" \
        --set "train.checkpoint_dir=$ck/$dir" --out "$out/$name.json" \
        > "$out/$name.txt" 2> "$out/$name.err"
    echo "sweep $name rc=$?"
}

t0=$(date +%s)
c3s="--set train.steps=2500 --set train.checkpoint_every=2500"
c1s="--set train.steps=3000 --set train.checkpoint_every=3000"
train c3 fusion_jscc --config c3 $c3r $c3s &
train c3_vq fusion_jscc --config c3 $c3vq $c3r $c3s &
train c3_vq_prune fusion_jscc --config c3 $c3vq --set lidar.vq_prune=true \
    $c3r $c3s &
train c1_vq jscc --config c1 $c1vq $c1s &
train c1_vq_prune jscc --config c1 $c1vq --set camera.vq_prune=true $c1s &
wait
echo "trainings: $(( $(date +%s) - t0 )) s"

t0=$(date +%s)
kinds="--kinds awgn,rayleigh"
sweep c3 c3 --config c3 $c3r $kinds &
sweep c3_vq c3_vq --config c3 $c3vq $c3r $kinds &
sweep c3_vq_soft c3_vq --config c3 $c3vq $c3r $kinds \
    --set channel.fec=hamming74_soft &
sweep c3_vq_hard c3_vq --config c3 $c3vq $c3r $kinds \
    --set channel.fec=hamming74 &
sweep c3_vq_entropy c3_vq --config c3 $c3vq $c3r $kinds --entropy-sweep &
sweep c3_vq_keep c3_vq_prune --config c3 $c3vq --set lidar.vq_prune=true \
    $c3r --keep-sweep &
sweep c1_vq_keep c1_vq_prune --config c1 $c1vq --set camera.vq_prune=true \
    --keep-sweep &
sweep c1_vq c1_vq --config c1 $c1vq $kinds &
sweep c1_vq_uep c1_vq --config c1 $c1vq $kinds --set channel.uep_alpha=0.25 &
sweep c1_vq_wf c1_vq --config c1 $c1vq $kinds --set channel.uep_mode=waterfill \
    --set channel.uep_alpha=1 &
sweep c1_vq_soft c1_vq --config c1 $c1vq $kinds \
    --set channel.fec=hamming74_soft &
sweep c1_vq_uep_soft c1_vq --config c1 $c1vq $kinds \
    --set channel.fec=hamming74_soft --set channel.uep_alpha=0.25 &
wait
echo "sweeps: $(( $(date +%s) - t0 )) s"
