"""Frozen dataclass configuration system with 5 named presets.

An own copy of ``multimodal_sc_tpu/config/configs.py``: the port imports
nothing of the JAX package. Fields keep their names and defaults so one
override string configures both packages.

Spec: BASELINE.json:7-11 names five driver configs; SURVEY.md §5.6 mandates
frozen dataclasses, presets, and dotted-path CLI overrides with no external
dependency. Reference repo has no config system (``README.md:1-2``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _replace_path(obj, path: str, value):
    """Immutable dotted-path override: replace(cfg, 'a.b.c', v)."""
    head, _, rest = path.partition(".")
    if not hasattr(obj, head):
        raise KeyError(f"no config field {head!r} on {type(obj).__name__}")
    if rest:
        sub = _replace_path(getattr(obj, head), rest, value)
        return dataclasses.replace(obj, **{head: sub})
    current = getattr(obj, head)
    if current is not None and not isinstance(current, type(value)):
        # Coerce strings from the CLI into the field's current type.
        if isinstance(current, bool):
            value = str(value).lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        elif isinstance(current, tuple):
            value = tuple(type(current[0])(v) for v in str(value).split(","))
    return dataclasses.replace(obj, **{head: value})


@dataclass(frozen=True)
class ChannelConfig:
    kind: str = "awgn"            # ideal | awgn | rayleigh | rician | ofdm
    snr_db: float = 10.0
    snr_min_db: float = -5.0      # for per-example SNR sweep training
    snr_max_db: float = 25.0
    random_snr: bool = False
    normalize: bool = True
    modulation: int = 0           # 0 = analog JSCC; 4/16/64 = square M-QAM
    pilots: int = 0               # 0 = perfect CSI; P>0 = LS estimate from
                                  # P unit-power pilots (fading kinds)
    ofdm_subcarriers: int = 64    # kind="ofdm" only
    ofdm_taps: int = 8            # multipath taps, exponential PDP
    fec: str = "none"             # none | hamming74 | hamming74_soft —
                                  # digital-path FEC (channel/fec.py; VQ
                                  # codec only, 7/4x bandwidth,
                                  # parameter-transparent; _soft = ML
                                  # correlation decode, ~2 dB better)
    uep_alpha: float = 0.0        # >0: semantic-importance unequal power
                                  # allocation on the VQ digital path —
                                  # per-token power ∝ damage^alpha at
                                  # fixed total power (semantic_vq.py;
                                  # parameter-transparent deployment)
    uep_mode: str = "alpha"       # alpha | waterfill (SNR-aware Chernoff
                                  # water-filling; uep_alpha>0 enables,
                                  # exponent ignored)
    uep_probes: int = 2           # VJP probes for the damage estimate
    harq: bool = False            # Type-I HARQ (channel/harq.py: CRC-8
                                  # blocks, NACK retransmission, chase
                                  # combining) on the RL digital token
                                  # links — camera, ego LiDAR, and the
                                  # V2X RSU stream (r5, VERDICT r4 item
                                  # 4). Deploy-time and parameter-
                                  # transparent like fec; bandwidth is
                                  # ADAPTIVE (per-step symbol cost is
                                  # sown + recorded by the policy sweep).
                                  # The reconstruction path's HARQ
                                  # deployment is `cli eval --harq-sweep`.
    harq_rounds: int = 4          # max transmission rounds per block
    harq_block_bits: int = 64     # payload bits per CRC-8 block
    v2x_snr_offset_db: float = 0.0  # V2X (RSU->ego) link SNR relative to
                                  # the deployed snr_db (env.v2x_rays > 0):
                                  # one radio environment, two links — the
                                  # infrastructure link may be better
                                  # (elevated antenna) or worse
    token_keep: float = 1.0       # deploy-time kept token fraction for
                                  # vq_prune models (< 1 transmits only
                                  # the selected tokens' symbols)
    token_select: str = "scatter"  # scatter | drop_damage_scatter |
                                  # drop_damage | damage | random —
                                  # deploy-time token selection rule.
                                  # Measured ordering on the r3 keep
                                  # sweep (BASELINE.md): scatter (pure
                                  # farthest-point spatial spread) wins
                                  # at every keep <= 0.5 — the random-
                                  # mask-trained decoder's inpainting
                                  # needs COVERAGE more than per-token
                                  # importance; drop_damage ranks by the
                                  # reconstruction damage of replacing
                                  # the token with the mask embedding
                                  # (beats bit-flip 'damage' but loses
                                  # to scatter); drop_damage_scatter
                                  # blends both ranks; random = ablation


    def __post_init__(self):
        # Fail at config construction, not at channel() trace time.
        kinds = ("ideal", "awgn", "rayleigh", "rician", "ofdm")
        if self.kind not in kinds:
            raise ValueError(
                f"channel.kind must be one of {kinds}, got {self.kind!r}")
        if self.fec not in ("none", "hamming74", "hamming74_soft"):
            raise ValueError(
                "channel.fec must be 'none', 'hamming74' or "
                f"'hamming74_soft', got {self.fec!r}")
        if self.pilots < 0:
            raise ValueError(f"channel.pilots must be >= 0, got {self.pilots}")
        if self.uep_alpha < 0:
            raise ValueError(
                f"channel.uep_alpha must be >= 0, got {self.uep_alpha}")
        if self.uep_mode not in ("alpha", "waterfill"):
            raise ValueError(
                "channel.uep_mode must be 'alpha' or 'waterfill', got "
                f"{self.uep_mode!r}")
        if not 0.0 < self.token_keep <= 1.0:
            raise ValueError(
                f"channel.token_keep must be in (0, 1], got "
                f"{self.token_keep}")
        selects = ("drop_damage", "damage", "random", "scatter",
                   "drop_damage_scatter")
        if self.token_select not in selects:
            raise ValueError(
                f"channel.token_select must be one of {selects}, got "
                f"{self.token_select!r}")
        if self.uep_probes < 1:
            raise ValueError(
                f"channel.uep_probes must be >= 1, got {self.uep_probes}")
        if self.ofdm_subcarriers < 1 or self.ofdm_taps < 1:
            raise ValueError("channel.ofdm_subcarriers and channel.ofdm_taps "
                             "must be >= 1")


@dataclass(frozen=True)
class CameraCodecConfig:
    arch: str = "cnn"             # cnn | vit | vq (discrete semantic tokens)
    image_hw: Tuple[int, int] = (32, 32)
    features: Tuple[int, ...] = (32, 64, 128, 128)
    c_sym: int = 8
    seg_classes: int = 0          # >0: receiver segmentation head (mIoU)
    snr_conditioning: bool = False
    # Bandwidth-agile JSCC (DeepJSCC-l style): train with per-example
    # random symbol-channel masking so ONE model deploys at any rate
    # m/c_sym, m in [rate_min_sym, c_sym]. CNN arch only.
    adaptive_rate: bool = False
    rate_min_sym: int = 1
    # ViT-specific
    patch: int = 4
    dim: int = 128
    depth: int = 4
    heads: int = 4
    # arch="vq" (codec/semantic_vq.py): discrete semantic tokens over a
    # QPSK digital channel. vq_codes must be a power of 4.
    vq_codes: int = 256
    vq_dim: int = 64
    vq_beta: float = 0.25
    # Codebook-usage regularization (r5, VERDICT r4 item 1 — the LiDAR
    # codebook collapsed to perplexity 6.8/256 and the camera's sat at
    # 42/256): usage_coef > 0 adds the soft-assignment entropy loss
    # (confident per-token, diverse across the batch — semantic_vq.py
    # vq_usage_loss); vq_reseed > 0 re-seeds each batch-dead code with
    # that probability per step to the highest-quantization-error encoder
    # outputs (reseed_dead_codes). Defaults off: the r3/r4 bars and
    # checkpoints are unchanged unless an arm opts in.
    vq_usage_coef: float = 0.0
    vq_usage_temp: float = 0.5    # dimensionless softmax scale (x mean d2)
    vq_reseed: float = 0.0        # per-step reseed probability, dead codes
    # Semantic token pruning (digital bandwidth elasticity): train with
    # per-example random token dropping + a learned mask embedding so
    # one model deploys at any keep fraction (channel.token_keep).
    vq_prune: bool = False
    vq_keep_min: float = 0.25     # training keep-fraction lower bound

    def __post_init__(self):
        if not 1 <= self.rate_min_sym <= self.c_sym:
            raise ValueError(
                f"camera.rate_min_sym must be in [1, c_sym={self.c_sym}], "
                f"got {self.rate_min_sym}")
        if self.adaptive_rate and self.arch != "cnn":
            raise ValueError("camera.adaptive_rate requires arch='cnn'")
        if self.vq_prune and self.arch != "vq":
            raise ValueError("camera.vq_prune requires arch='vq'")
        if not 0.0 < self.vq_keep_min <= 1.0:
            raise ValueError(
                f"camera.vq_keep_min must be in (0, 1], got "
                f"{self.vq_keep_min}")


@dataclass(frozen=True)
class LidarCodecConfig:
    enabled: bool = False
    arch: str = "analog"          # analog (continuous JSCC symbols) | vq
    # (discrete codebook indices over the QPSK digital link — the LiDAR
    # counterpart of camera.arch="vq"; r4, VERDICT r3 item 4). On c3 it
    # builds codec/lidar_bev.py LidarBEVVQCodec; on c4/c5 it routes the
    # RL trunk's LiDAR branch — INCLUDING the V2X RSU link — through the
    # digital path (rl/perception.py). Bandwidth-matched to analog at the
    # defaults: c3 32x32 grid -> 1024 tok x 8 bit = 4096 QPSK symbols ==
    # 32*32*c_sym(4); c4 16x16 grid -> 256 x 8 = 1024 == 16*16*c_sym(4).
    vq_codes: int = 256           # codebook size (power of 4)
    vq_dim: int = 32              # code dimension
    vq_beta: float = 0.25         # commitment weight
    # Codebook-usage regularization + dead-code re-seeding — the r5 fix
    # for the r4 BEV codebook collapse (perplexity 6.8/256, VERDICT r4
    # item 1). Same semantics as the camera fields (see CameraCodecConfig).
    vq_usage_coef: float = 0.0
    vq_usage_temp: float = 0.5
    vq_reseed: float = 0.0
    # Semantic token pruning on the BEV digital link (r5, VERDICT r4
    # item 5 — the LiDAR counterpart of camera.vq_prune): train with
    # per-example random token dropping + a learned mask embedding so
    # one checkpoint deploys at any kept-token fraction
    # (channel.token_keep); deploy-time selection via
    # channel.token_select. Requires lidar.arch='vq'.
    vq_prune: bool = False
    vq_keep_min: float = 0.25     # training keep-fraction lower bound
    max_points: int = 1024
    max_pillars: int = 256
    points_per_pillar: int = 16
    bev_hw: Tuple[int, int] = (16, 16)
    seg_classes: int = 1          # 1 = binary occupancy; >1 = semantic BEV
                                  # (classes incl. 0 = empty, datasets.BEV_CLASSES)
    point_features: int = 4       # x, y, z, intensity
    pillar_dim: int = 64
    c_sym: int = 4
    x_range: Tuple[float, float] = (0.0, 48.0)
    y_range: Tuple[float, float] = (-12.0, 12.0)

    def __post_init__(self):
        if self.arch not in ("analog", "vq"):
            raise ValueError(
                f"lidar.arch must be 'analog' or 'vq', got {self.arch!r}")
        if self.vq_prune and self.arch != "vq":
            raise ValueError("lidar.vq_prune requires lidar.arch='vq'")
        if not 0.0 < self.vq_keep_min <= 1.0:
            raise ValueError(
                f"lidar.vq_keep_min must be in (0, 1], got "
                f"{self.vq_keep_min}")


@dataclass(frozen=True)
class FusionConfig:
    mode: str = "cross_attention"  # cross_attention | late_concat
    dim: int = 128
    depth: int = 2
    heads: int = 4
    state_dim: int = 128


@dataclass(frozen=True)
class EnvConfig:
    name: str = "drive-v0"
    num_npcs: int = 4
    camera_mode: str = "topdown"  # topdown | front (perspective pinhole)
    image_hw: Tuple[int, int] = (32, 32)
    lidar_rays: int = 64
    lidar_road: bool = True       # rays also return road-boundary (curb)
    # hits with distinct (z, intensity), so the LiDAR modality carries lane
    # geometry, not just NPC obstacles (VERDICT r2 item 5)
    max_steps: int = 128
    dt: float = 0.1
    num_lanes: int = 3
    lane_width: float = 4.0
    fog_range: float = 0.0        # >0: ego sensor visibility limit (m) —
    # camera pixels beyond it fade to fog gray, ego LiDAR returns beyond it
    # are dropped. 0 = clear sky (every pre-existing config).
    v2x_rays: int = 0             # >0: V2X cooperative perception — a
    # roadside unit (RSU) v2x_lookahead meters ahead runs its own
    # lidar scan (this many rays, NOT fog-limited: elevated mast above the
    # fog layer) and its points are appended to the observation; the
    # perception trunk encodes them with the SAME LiDAR semantic codec and
    # ships the tokens over the channel (the RSU->ego link). 0 = off.
    v2x_lookahead: float = 24.0   # RSU position ahead of the ego (m, arc)

    def __post_init__(self):
        if self.fog_range < 0:
            raise ValueError(
                f"env.fog_range must be >= 0, got {self.fog_range}")
        if self.v2x_rays < 0:
            raise ValueError(
                f"env.v2x_rays must be >= 0, got {self.v2x_rays}")


@dataclass(frozen=True)
class RLConfig:
    algo: str = "dqn"             # dqn | ppo
    num_actions: int = 9          # 3 steer x 3 accel
    gamma: float = 0.99
    # DQN
    replay_capacity: int = 16384
    batch_size: int = 128
    target_update_period: int = 200
    target_tau: float = 0.0       # >0: soft (Polyak) target update
    # target <- (1-tau)*target + tau*params every learn step, instead of
    # the hard periodic copy above. Standard value-learning stabilizer
    # (dampens the TD-target oscillation behind the cold-c4 chattering
    # diagnosis, BASELINE.md config-4); 0 keeps the hard-sync behavior.
    ema_tau: float = 0.0          # >0: track a Polyak-averaged copy of the
    # ONLINE params (ema <- ema + tau*(params - ema)) as the DEPLOYMENT
    # policy — once per learn step for DQN (decoupled from the TD-target
    # network above), once per update for PPO. The r3 cold-c4 recipe study
    # measured the averaged policy above the final snapshot in every
    # stabilized arm (104.5/110.5 vs 108.8/90.6 greedy across seeds —
    # results_r3/collapse_investigation.md); eval with
    # `eval-policy --use-ema`. 0 leaves the EMA frozen at init.
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 20000
    double_dqn: bool = True
    n_step: int = 1               # n-step returns (rl/nstep.py); 1 = vanilla
    vq_loss_coef: float = 1.0     # weight of the VQ codebook+commitment
    # loss added to the TD/PPO loss when camera.arch == "vq" (the RL
    # objective's gradients ride the straight-through path and never move
    # the codebook; this term is what trains it — mirrors the jscc driver
    # adding aux["vq_loss"] to the MSE)
    ablate_lidar: bool = False    # zero the LiDAR input in the perception
    # trunk (points and mask) — the camera-only ablation arm; same params/
    # init as the full model so eval returns are directly comparable
    replay_quantize: bool = True  # store replay images as uint8 (4x fewer
    # bytes; images are rendered in [0,1], so the 1/255 step is far below
    # sensor noise — the standard DQN frame store)
    eval_snapshot_every: int = 0  # >0: greedy-eval the online params every
    # this many iterations during DQN training (fixed eval key, so scores
    # are comparable across snapshots) and keep the BEST tree; the driver
    # persists it under <checkpoint_dir>/best and eval-policy --use-best
    # deploys it. Deployment-side antidote to TD snapshot oscillation
    # (results_r3/collapse_investigation.md): the final snapshot can land
    # in a transient bad basin while a 250-iter-earlier one evals 4x
    # better — select on measured return, not recency. 0 = off.
    eval_snapshot_envs: int = 64  # episodes per in-training snapshot eval
    # PPO
    rollout_length: int = 64
    num_envs: int = 32
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ppo_epochs: int = 4
    num_minibatches: int = 4
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    entropy_floor: float = 0.0    # >0: hinge penalty that activates only
    # when the policy entropy falls BELOW this floor —
    # loss += entropy_floor_coef * relu(floor - H(pi)). Targets the r4
    # worst-seed failure (c5 seed 3 self-annealed to H=0.55 and sampled
    # 58.0 vs the 65+ band; healthy seeds sit at 1.16-1.25, so a floor of
    # ~1.0 leaves them untouched — VERDICT r4 item 3). 0 = off.
    entropy_floor_coef: float = 0.1
    entropy_coef_final: float = -1.0  # >=0: linearly anneal the entropy
    # coefficient from entropy_coef to this value over train.steps updates
    # (sharpens the policy so short-budget runs eval well greedily);
    # negative = constant coefficient (the r2 behavior)
    rollout_quantize: bool = False  # store PPO rollout images as uint8
    # (4x fewer bytes on the (T*B,H,W,3) stack + its per-minibatch
    # gathers). The loss then recomputes logits on dequantized frames —
    # a 1/255 perturbation on top of the already-accepted resampled
    # channel noise (_ppo_loss key note). Off until measured faster on
    # TPU (kernel-flag convention).


@dataclass(frozen=True)
class TrainConfig:
    task: str = "jscc"            # jscc | dqn | ppo
    steps: int = 1000
    iters_per_dispatch: int = 1   # All training drivers: lax.scan this many
    # steps per device dispatch (amortizes the per-dispatch host round
    # trip; metrics cadence preserved — the scan returns per-step metrics
    # stacked). Falls back to single steps around eval/checkpoint
    # boundaries so their cadence stays exact.
    batch_size: int = 64
    lr: float = 1e-3
    warmup_steps: int = 100
    eval_every: int = 200
    log_every: int = 50
    checkpoint_every: int = 500
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None   # jax.profiler trace output
    seed: int = 0
    dataset: str = "synthetic_cifar"  # synthetic_cifar | synthetic_kitti | cifar | kitti
    data_root: str = "data"       # real-dataset root (cifar-10-batches-py/, kitti/)
    grad_clip: float = 1.0
    bf16: bool = False


@dataclass(frozen=True)
class MeshConfig:
    data_axis: int = -1           # -1 = all available devices
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "c1_jscc_awgn"
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    camera: CameraCodecConfig = field(default_factory=CameraCodecConfig)
    lidar: LidarCodecConfig = field(default_factory=LidarCodecConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    rl: RLConfig = field(default_factory=RLConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    use_pallas: bool = False      # all fused Pallas kernels (conv+attn+scatter)
    # in the JAX package; in the port the conv and scatter kernels always
    # run on a CUDA tensor, so the flag only selects attention kernels.
    pallas_mha_block: bool = False  # whole-MHA-span fused kernel in the
    # fusion transformer (LN+QKV+attention+out-proj+residual as ONE Pallas
    # program — kernels/mha_block.py, the r2-verdict widened-fusion
    # experiment). NOTE: changes the fusion param tree (packed weights), so
    # checkpoints do not transfer across a flip.
    mha_block_kernel: bool = True  # EXECUTION switch for the fused blocks:
    # True runs the kernel, False the plain version on the SAME packed
    # param tree (structure is governed by pallas_mha_block alone, so
    # checkpoints transfer across this flag). The learner losses force it
    # False.
    pallas_attention: bool = False  # attention kernels only (packed-head
    # kernel at flagship shapes, generic flash otherwise).

    def validate(self) -> "ExperimentConfig":
        """Cross-field validation — every accepted-but-silently-ignored
        flag combination is a hard error (VERDICT r3 item 6: silent config
        degradation is the same failure class as the r3 missing-checkpoint
        silent fallback). Lives outside ``__post_init__`` because CLI
        overrides apply one assignment at a time and intermediate states
        may legitimately be inconsistent; the CLI and train drivers call
        this once on the final config. Returns self for chaining."""
        rl_task = self.train.task in ("dqn", "ppo")
        cam = self.camera
        ch = self.channel
        if rl_task:
            if cam.snr_conditioning and cam.arch != "cnn":
                raise ValueError(
                    "camera.snr_conditioning on the RL path requires "
                    f"camera.arch='cnn' (got {cam.arch!r}) — the RL ViT "
                    "branch is built unconditioned and the VQ digital "
                    "branch has no FiLM; the flag would be silently "
                    "ignored (rl/perception.py)")
            if cam.adaptive_rate:
                raise ValueError(
                    "camera.adaptive_rate is a reconstruction-codec "
                    "feature (c1/c2); the RL perception trunk has no rate "
                    "conditioning and would silently ignore it")
            if cam.vq_prune:
                raise ValueError(
                    "camera.vq_prune (semantic token pruning) is not "
                    "supported on the RL path yet — the trunk transmits "
                    "every camera token (LiDAR pruning: lidar.vq_prune)")
            if self.lidar.vq_prune and ch.token_keep < 1.0 \
                    and ch.token_select not in ("scatter", "random"):
                raise ValueError(
                    "on the RL path lidar token pruning supports only "
                    "content-free selection rules (channel.token_select "
                    "'scatter' or 'random') — the damage rules probe the "
                    f"reconstruction decoder's VJP, got "
                    f"{ch.token_select!r}")
            if ch.uep_alpha > 0:
                raise ValueError(
                    "channel.uep_alpha (semantic UEP) is not supported on "
                    "the RL path: the damage estimator probes the IMAGE "
                    "decoder's VJP, which is not part of the RL graph")
        if cam.snr_conditioning and cam.arch == "vq":
            raise ValueError(
                "camera.snr_conditioning has no effect on the VQ codec "
                "(discrete indices carry no FiLM path); unset it or use "
                "arch='cnn'/'vit'")
        if self.train.task == "jscc_fusion" and cam.arch == "vq":
            raise ValueError(
                "camera.arch='vq' is not supported on the fusion task "
                "(train/fusion_jscc.py builds only cnn/vit camera codecs "
                "and would silently build the analog CNN — ADVICE r4); "
                "use lidar.arch='vq' for the digital half of c3, or train "
                "the VQ camera on c1/c2 (task='jscc')")
        if self.lidar.arch == "vq" and not self.lidar.enabled \
                and not rl_task:
            raise ValueError(
                "lidar.arch='vq' requires lidar.enabled=true on the "
                "reconstruction tasks — without an active LiDAR branch the "
                "flag is silently ignored (and channel.fec would then pass "
                "validation while coding nothing)")
        if ch.token_keep < 1.0 and not (cam.vq_prune or self.lidar.vq_prune):
            raise ValueError(
                "channel.token_keep < 1 requires a token-pruned VQ codec "
                "(camera.vq_prune=true or lidar.vq_prune=true); otherwise "
                "every token is transmitted and the flag is silently "
                "ignored")
        if ch.uep_alpha > 0 and cam.arch != "vq":
            raise ValueError(
                "channel.uep_alpha requires the digital VQ codec "
                f"(camera.arch='vq', got {cam.arch!r}); the analog paths "
                "would silently ignore it")
        if ch.fec != "none" and cam.arch != "vq" \
                and self.lidar.arch != "vq":
            raise ValueError(
                "channel.fec requires a digital codec (camera.arch='vq' "
                "or lidar.arch='vq'); the analog JSCC paths transmit "
                "continuous symbols and would silently ignore FEC")
        if ch.harq:
            if not rl_task:
                raise ValueError(
                    "channel.harq deploys the RL perception links "
                    "(train.task dqn/ppo); for the reconstruction path "
                    "use `cli eval --harq-sweep` (same protocol, exact "
                    "per-image accounting)")
            if cam.arch != "vq" and self.lidar.arch != "vq":
                raise ValueError(
                    "channel.harq requires a digital token link "
                    "(camera.arch='vq' or lidar.arch='vq'); the analog "
                    "paths have no blocks to CRC")
            if ch.fec != "none":
                raise ValueError(
                    "channel.harq and channel.fec are mutually exclusive "
                    "deployments here (Type-I chase combining already "
                    "supplies adaptive low-SNR redundancy; combined "
                    "FEC+HARQ is not implemented)")
            if self.lidar.vq_prune or cam.vq_prune:
                raise ValueError(
                    "channel.harq with token pruning is not implemented "
                    "(the HARQ block layout assumes every token's bits "
                    "are present); deploy one bandwidth mechanism at a "
                    "time")
        if ch.modulation > 0 and cam.arch == "vq":
            raise ValueError(
                "channel.modulation (analog M-QAM STE) conflicts with "
                "camera.arch='vq' — the VQ codec maps its own QPSK "
                "constellation and would silently ignore the flag")
        return self

    def override(self, **dotted: Any) -> "ExperimentConfig":
        cfg = self
        for path, value in dotted.items():
            cfg = _replace_path(cfg, path, value)
        return cfg

    def override_str(self, assignments) -> "ExperimentConfig":
        cfg = self
        for a in assignments:
            path, _, value = a.partition("=")
            cfg = _replace_path(cfg, path.strip(), value.strip())
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)
