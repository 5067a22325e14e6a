"""The five named presets, an own copy of ``multimodal_sc_tpu/config/presets.py``
(the port imports nothing of the JAX package)."""

from __future__ import annotations

from multimodal_sc_torch.config.configs import (
    CameraCodecConfig,
    ChannelConfig,
    ExperimentConfig,
    FusionConfig,
    LidarCodecConfig,
    RLConfig,
    TrainConfig,
)


def c1_jscc_awgn() -> ExperimentConfig:
    """Config 1 (BASELINE.json:7): single-camera CNN JSCC autoencoder over
    AWGN at fixed SNR, CIFAR/KITTI crops."""
    return ExperimentConfig(
        name="c1_jscc_awgn",
        channel=ChannelConfig(kind="awgn", snr_db=10.0),
        camera=CameraCodecConfig(arch="cnn"),
        train=TrainConfig(task="jscc", steps=2000, dataset="synthetic_cifar"),
    )


def c2_snr_sweep() -> ExperimentConfig:
    """Config 2 (BASELINE.json:8): SNR-sweep JSCC eval (AWGN + Rayleigh,
    power-normalized) with PSNR/mIoU curves; SNR-conditioned model."""
    return ExperimentConfig(
        name="c2_snr_sweep",
        channel=ChannelConfig(kind="awgn", random_snr=True),
        # 4-class receiver segmentation (datasets.SEG_CLASSES: bg/box/disk/
        # stripe) — the non-saturating gate of VERDICT r1 item 3.
        camera=CameraCodecConfig(arch="cnn", snr_conditioning=True,
                                 seg_classes=4),
        train=TrainConfig(task="jscc", steps=3000, dataset="synthetic_cifar"),
    )


def c3_lidar_fusion() -> ExperimentConfig:
    """Config 3 (BASELINE.json:9): LiDAR point-cloud -> BEV pillar encoder +
    camera branch, late-fusion semantic TX."""
    return ExperimentConfig(
        name="c3_lidar_fusion",
        channel=ChannelConfig(kind="awgn", snr_db=10.0),
        camera=CameraCodecConfig(arch="vit", image_hw=(64, 64)),
        # Semantic 4-class BEV on a 32x32 grid with sensor noise (VERDICT
        # r1 item 3) instead of the saturated 16x16 binary occupancy.
        lidar=LidarCodecConfig(enabled=True, bev_hw=(32, 32), seg_classes=4),
        fusion=FusionConfig(mode="late_concat"),
        train=TrainConfig(task="jscc_fusion", steps=2000,
                          dataset="synthetic_kitti"),
    )


def c4_dqn_fusion() -> ExperimentConfig:
    """Config 4 (BASELINE.json:10): cross-attention fusion transformer + DQN
    driving policy, batched replay on-device."""
    return ExperimentConfig(
        name="c4_dqn_fusion",
        channel=ChannelConfig(kind="awgn", snr_db=10.0),
        camera=CameraCodecConfig(arch="cnn"),
        lidar=LidarCodecConfig(enabled=True),
        fusion=FusionConfig(mode="cross_attention"),
        # VERDICT r1 item 8 tuning: 64 envs (was 16), 3-step returns,
        # deeper replay, eps annealed over the first 3k of 5k iterations.
        # r3 recipe study (results_r3/collapse_investigation.md): lr 1e-4
        # with hard target sync is the stabilized cold recipe (greedy
        # 108.8/90.6 across seeds vs 30-and-collapsing at the old 1e-3);
        # ema_tau 2e-3 tracks the Polyak-averaged deployment policy
        # (~500-iter horizon — the measured-best deployment, 104.5/110.5).
        rl=RLConfig(algo="dqn", num_envs=64, n_step=3,
                    replay_capacity=32768, eps_decay_steps=3000,
                    ema_tau=2e-3),
        train=TrainConfig(task="dqn", steps=5000, batch_size=128,
                          iters_per_dispatch=50, lr=1e-4),
        # Whole-MHA-span fused block (kernels/mha_block.py). Structure
        # flag: packed param tree; tiny test overrides (fusion.dim=32) are
        # block-ineligible and fall back to the plain version.
        pallas_mha_block=True,
    )


def c5_ppo_mesh() -> ExperimentConfig:
    """Config 5 (BASELINE.json:11): closed-loop PPO driving agent with
    end-to-end semantic-comm on a TPU mesh."""
    return ExperimentConfig(
        name="c5_ppo_mesh",
        channel=ChannelConfig(kind="awgn", snr_db=10.0),
        camera=CameraCodecConfig(arch="cnn"),
        lidar=LidarCodecConfig(enabled=True),
        fusion=FusionConfig(mode="cross_attention"),
        # ema_tau 0.02 tracks a ~50-update-horizon Polyak average of the
        # policy as the deployment candidate (passive — training numerics
        # unchanged); deploy/eval it with --use-ema. Mirrors the c4 EMA
        # deployment policy at the PPO update cadence.
        rl=RLConfig(algo="ppo", ema_tau=0.02),
        # r3 lr study (results_r3/ppo_recipe.json, 5 arms x 2 seeds):
        # 3e-4 beats the old 1e-3 default on every deployment mode by
        # min-across-seeds (sampled 68.5/82.5, EMA greedy 60.0/72.4 vs
        # 46.7 at 1e-3); 1e-4 is close but loses on sampled (55.8).
        # 300 updates at 3e-4 did NOT beat 150 (greedy 48.2) — keep the
        # 150-update budget for the bar runs.
        train=TrainConfig(task="ppo", steps=500, lr=3e-4),
        # Fused MHA blocks, as on c4.
        pallas_mha_block=True,
    )


PRESETS = {
    "c1": c1_jscc_awgn,
    "c2": c2_snr_sweep,
    "c3": c3_lidar_fusion,
    "c4": c4_dqn_fusion,
    "c5": c5_ppo_mesh,
    "c1_jscc_awgn": c1_jscc_awgn,
    "c2_snr_sweep": c2_snr_sweep,
    "c3_lidar_fusion": c3_lidar_fusion,
    "c4_dqn_fusion": c4_dqn_fusion,
    "c5_ppo_mesh": c5_ppo_mesh,
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name]()
