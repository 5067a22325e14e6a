#!/usr/bin/env bash
# The sharded drivers on four cards, one process each (torchrun, NCCL),
# each beside its single-card run: c4 DQN at 4 x 1024 envs with sharded
# checkpoints, a resume and eval-policy on them; c5 PPO on a data axis of
# 4 at the preset's 32 envs and at 4 x 32, and on data 2 x model 2 (tensor
# parallelism), checkpointed there, resumed at data 2 x model 1 and
# evaluated on one card; c5 over both digital links on a data axis of 4; c1
# JSCC and c1_vq (usage and re-seeding pooled) at a global batch of 256.
# Prints the card, the build time, and each run's last lines (its result
# JSON). Run from the repository root on a four-card machine:
#     bash scripts/torch_four_cards.sh
set -o pipefail
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# Built once here: the ranks then load the libraries.
python3 -c "import time; from multimodal_sc_torch.kernels import _build; t=time.time(); _build.build(); print(f'built in {time.time()-t:.1f} s', flush=True)"
export OMP_NUM_THREADS=4
ckpt=$(mktemp -d)
ckpt_tp=$(mktemp -d)
digital="--set camera.arch=vq --set lidar.arch=vq --set camera.vq_reseed=0.05 --set lidar.vq_usage_coef=0.05 --set lidar.vq_reseed=0.05"
run() { echo "== $*"; "$@" 2>&1 | grep -v -e '^\[step' -e 'destroy_process_group' | tail -5; }
run python3 -m multimodal_sc_torch.train.dqn --config c4 --set train.steps=40 --eval-envs 64
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.dqn --config c4 --set rl.num_envs=4096 --set train.steps=40 --set train.checkpoint_dir="$ckpt" --set train.checkpoint_every=20 --eval-envs 64
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.dqn --config c4 --set rl.num_envs=4096 --set train.steps=60 --set train.checkpoint_dir="$ckpt" --set train.checkpoint_every=20 --eval-envs 64
ls "$ckpt"
run python3 -m multimodal_sc_torch.evaluation.policy_eval --config c4 --set rl.num_envs=4096 --set train.checkpoint_dir="$ckpt" --use-ema --episodes 64
run python3 -m multimodal_sc_torch.train.ppo --config c5 --set train.steps=3 --eval-envs 32
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.ppo --config c5 --set train.steps=3 --eval-envs 32
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.ppo --config c5 --set rl.num_envs=128 --set train.steps=3 --eval-envs 32
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.ppo --config c5 --set mesh.model_axis=2 --set train.steps=3
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.ppo --config c5 --set mesh.model_axis=2 --set train.steps=2 --set train.checkpoint_dir="$ckpt_tp" --set train.checkpoint_every=1
run torchrun --nproc-per-node 2 -m multimodal_sc_torch.train.ppo --config c5 --set train.steps=3 --set train.checkpoint_dir="$ckpt_tp" --set train.checkpoint_every=1
run python3 -m multimodal_sc_torch.evaluation.policy_eval --config c5 --set train.checkpoint_dir="$ckpt_tp" --use-ema --episodes 32
run python3 -m multimodal_sc_torch.train.ppo --config c5 $digital --set train.steps=3 --eval-envs 32
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.ppo --config c5 $digital --set train.steps=3 --eval-envs 32
run python3 -m multimodal_sc_torch.train.jscc --config c1 --set train.steps=100
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.jscc --config c1 --set train.batch_size=256 --set train.steps=100
vq="--set camera.arch=vq --set camera.vq_usage_coef=0.1 --set camera.vq_reseed=0.3"
run python3 -m multimodal_sc_torch.train.jscc --config c1 $vq --set train.steps=100
run torchrun --nproc-per-node 4 -m multimodal_sc_torch.train.jscc --config c1 $vq --set train.batch_size=256 --set train.steps=100
rm -rf "$ckpt" "$ckpt_tp"
