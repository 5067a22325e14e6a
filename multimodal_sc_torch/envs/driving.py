"""Vectorized driving environment on tensors with a leading env dimension.

Counterpart of ``multimodal_sc_tpu/envs/driving.py`` (curved multi-lane
road in Frenet coordinates, NPC car-following and lane changes, OBB
collisions, ego-centric top-down camera, ray-cast LiDAR with curb returns,
auto-reset). The JAX package vmapped per-env functions; here every function
takes the batch dimension first. Each random draw is separate from its use:
``reset`` and ``step`` take their uniforms and integers as ``ResetDraws`` /
``StepDraws``, which ``draw_reset`` / ``draw_step`` sample from a
``torch.Generator`` (and a test can build from the JAX package's keys).
Both cameras are ported (the top-down view and the pinhole front camera),
and the V2X roadside unit's scan is appended to the ego LiDAR rays.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from multimodal_sc_torch.config.configs import EnvConfig
from multimodal_sc_torch.device import resolve_device

# Vehicle geometry / dynamics constants (as in the JAX package).
WHEELBASE = 2.5
CAR_HALF_LEN = 2.2
CAR_HALF_WID = 0.9
V_MAX = 20.0
NPC_V_MIN, NPC_V_MAX = 4.0, 10.0
SPAWN_AHEAD_MIN, SPAWN_AHEAD_MAX = 10.0, 45.0
BEHIND_CUTOFF = -8.0
LIDAR_MAX_RANGE = 50.0
NPC_RADIUS = 1.6
LANE_CHANGE_PROB = 0.012
LAT_RATE = 1.5
FOLLOW_GAP = 9.0
NPC_BRAKE = 3.0

CURV_A1 = (0.004, 0.014)
CURV_LAM1 = (80.0, 160.0)
CURV_A2 = (0.001, 0.005)
CURV_LAM2 = (30.0, 70.0)

STEERS = (-0.25, 0.0, 0.25)
ACCELS = (-4.0, 0.0, 3.0)
FOG_COLOR = (0.55, 0.55, 0.58)

_CURB_SAMPLES = 24
_CURB_Z = 0.15
_CURB_INTENSITY = 0.4
_NPC_Z = 0.5
_NPC_INTENSITY = 1.0


class EnvState(NamedTuple):
    ego: torch.Tensor     # (B, 4) s, d, mu, v (Frenet)
    npcs: torch.Tensor    # (B, N, 5) s, d, v, d_target, v_cruise
    road: torch.Tensor    # (B, 6) a1, w1, p1, a2, w2, p2 curvature profile
    t: torch.Tensor       # (B,) int32 step counter
    fog: torch.Tensor     # (B,) f32 visibility limit (m); <= 0 = clear


class TimeStep(NamedTuple):
    image: torch.Tensor   # (B, H, W, 3) f32 in [0, 1]
    points: torch.Tensor  # (B, R, 4) x, y, z, intensity in the ego frame
    mask: torch.Tensor    # (B, R) bool valid hits
    reward: torch.Tensor  # (B,) f32
    done: torch.Tensor    # (B,) bool
    info: dict


class ResetDraws(NamedTuple):
    """The random values one reset consumes, already in their ranges."""
    road: torch.Tensor       # (B, 6) as EnvState.road
    ego_lane: torch.Tensor   # (B,) int in [0, num_lanes)
    ego_v: torch.Tensor      # (B,) in [3, 8)
    npc_s: torch.Tensor      # (B, N) in [SPAWN_AHEAD_MIN, SPAWN_AHEAD_MAX)
    npc_lane: torch.Tensor   # (B, N) int
    npc_v: torch.Tensor      # (B, N) in [NPC_V_MIN, NPC_V_MAX)


class NPCDraws(NamedTuple):
    """The random values one traffic update consumes."""
    change_u: torch.Tensor    # (B, N) uniform [0, 1): lane-change start
    dir_u: torch.Tensor       # (B, N) uniform [0, 1): direction (< 0.5 left)
    spawn_s: torch.Tensor     # (B, N) respawn distance ahead of the ego
    spawn_lane: torch.Tensor  # (B, N) int respawn lane
    spawn_v: torch.Tensor     # (B, N) respawn speed


class StepDraws(NamedTuple):
    npc: NPCDraws
    reset: ResetDraws        # the auto-reset state, used where done


def _uniform(shape, lo, hi, generator, device):
    return lo + torch.rand(shape, generator=generator, device=device) * (hi - lo)


def draw_reset(cfg: EnvConfig, batch: int, generator: torch.Generator,
               device) -> ResetDraws:
    n, dev, g = cfg.num_npcs, device, generator
    two_pi = 2.0 * math.pi
    road = torch.stack([
        _uniform((batch,), *CURV_A1, g, dev),
        two_pi / _uniform((batch,), *CURV_LAM1, g, dev),
        _uniform((batch,), 0.0, two_pi, g, dev),
        _uniform((batch,), *CURV_A2, g, dev),
        two_pi / _uniform((batch,), *CURV_LAM2, g, dev),
        _uniform((batch,), 0.0, two_pi, g, dev)], dim=-1)
    return ResetDraws(
        road=road,
        ego_lane=torch.randint(0, cfg.num_lanes, (batch,), generator=g,
                               device=dev),
        ego_v=_uniform((batch,), 3.0, 8.0, g, dev),
        npc_s=_uniform((batch, n), SPAWN_AHEAD_MIN, SPAWN_AHEAD_MAX, g, dev),
        npc_lane=torch.randint(0, cfg.num_lanes, (batch, n), generator=g,
                               device=dev),
        npc_v=_uniform((batch, n), NPC_V_MIN, NPC_V_MAX, g, dev))


def draw_step(cfg: EnvConfig, batch: int, generator: torch.Generator,
              device) -> StepDraws:
    n, dev, g = cfg.num_npcs, device, generator
    npc = NPCDraws(
        change_u=torch.rand((batch, n), generator=g, device=dev),
        dir_u=torch.rand((batch, n), generator=g, device=dev),
        spawn_s=_uniform((batch, n), SPAWN_AHEAD_MIN, SPAWN_AHEAD_MAX, g, dev),
        spawn_lane=torch.randint(0, cfg.num_lanes, (batch, n), generator=g,
                                 device=dev),
        spawn_v=_uniform((batch, n), NPC_V_MIN, NPC_V_MAX, g, dev))
    return StepDraws(npc=npc, reset=draw_reset(cfg, batch, g, dev))


def _road_half_width(cfg: EnvConfig) -> float:
    return cfg.num_lanes * cfg.lane_width / 2.0


def _lane_centers(cfg: EnvConfig, device) -> torch.Tensor:
    i = torch.arange(cfg.num_lanes, dtype=torch.float32, device=device)
    return (i - (cfg.num_lanes - 1) / 2.0) * cfg.lane_width


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace``'s float32 arithmetic, value for value."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def action_table(device=None):
    """9 discrete actions = steer x accel grids (action = 3*steer + accel)."""
    s = torch.tensor(STEERS, device=device).repeat_interleave(3)
    a = torch.tensor(ACCELS, device=device).repeat(3)
    return s, a


def _per_env(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ...) broadcasting against ``like`` (B, ...)."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def curvature(road: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """kappa(s) for s of shape (B, ...) from each env's profile."""
    a1, w1, p1, a2, w2, p2 = (_per_env(road[:, i], s) for i in range(6))
    return a1 * torch.sin(w1 * s + p1) + a2 * torch.sin(w2 * s + p2)


def curvature_rate(road: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    a1, w1, p1, a2, w2, p2 = (_per_env(road[:, i], s) for i in range(6))
    return a1 * w1 * torch.cos(w1 * s + p1) + a2 * w2 * torch.cos(w2 * s + p2)


def reset(cfg: EnvConfig, draws: ResetDraws,
          fog: Optional[torch.Tensor] = None) -> EnvState:
    """Fresh episodes from ``draws``; ``fog`` (B,) overrides cfg.fog_range."""
    dev = draws.road.device
    lanes = _lane_centers(cfg, dev)
    b = draws.road.shape[0]
    zeros = torch.zeros((b,), dtype=torch.float32, device=dev)
    ego = torch.stack([zeros, lanes[draws.ego_lane], zeros, draws.ego_v], -1)
    npc_d = lanes[draws.npc_lane]
    npcs = torch.stack([draws.npc_s, npc_d, draws.npc_v, npc_d, draws.npc_v],
                       dim=-1)
    if fog is None:
        fog = torch.full((b,), cfg.fog_range, dtype=torch.float32, device=dev)
    return EnvState(ego=ego, npcs=npcs, road=draws.road,
                    t=torch.zeros((b,), dtype=torch.int32, device=dev),
                    fog=fog)


def _dynamics(cfg: EnvConfig, road, ego, steer, accel):
    """Frenet-frame bicycle step -> (new ego, s_dot)."""
    s, d, mu, v = ego.unbind(-1)
    kap = curvature(road, s)
    denom = torch.clamp(1.0 - d * kap, min=0.3)
    s_dot = v * torch.cos(mu) / denom
    s = s + s_dot * cfg.dt
    d = d + v * torch.sin(mu) * cfg.dt
    mu = mu + (v / WHEELBASE * torch.tan(steer) - kap * s_dot) * cfg.dt
    mu = torch.clamp(mu, -1.0, 1.0)
    v = torch.clamp(v + accel * cfg.dt, 0.0, V_MAX)
    return torch.stack([s, d, mu, v], dim=-1), s_dot


def _advance_npcs(cfg: EnvConfig, npcs, ego, draws: NPCDraws):
    """Car-following + stochastic lane changes + respawn behind the ego."""
    s, d, v, d_tgt, v_cruise = npcs.unbind(-1)              # (B, N) each
    lanes = _lane_centers(cfg, npcs.device)
    all_s = torch.cat([s, ego[:, 0:1]], dim=1)               # (B, N+1)
    all_d = torch.cat([d, ego[:, 1:2]], dim=1)
    all_v = torch.cat([v, ego[:, 3:4]], dim=1)
    gap = all_s[:, None, :] - s[:, :, None]                  # (B, N, N+1)
    same_lane = (all_d[:, None, :] - d[:, :, None]).abs() < cfg.lane_width * 0.5
    ahead = (gap > 0.1) & same_lane
    gap_masked = torch.where(ahead, gap, torch.full_like(gap, 1e6))
    leader = gap_masked.argmin(dim=-1)                       # first minimum
    leader_gap = gap_masked.gather(-1, leader[..., None])[..., 0]
    leader_v = all_v.gather(1, leader)
    too_close = (leader_gap < FOLLOW_GAP) & (leader_v < v)
    dv = torch.where(too_close, torch.full_like(v, -NPC_BRAKE),
                     torch.clamp(v_cruise - v, -NPC_BRAKE, NPC_BRAKE))
    v = torch.clamp(v + dv * cfg.dt, 0.0, NPC_V_MAX)

    settled = (d - d_tgt).abs() < 0.05
    start = settled & (draws.change_u < LANE_CHANGE_PROB)
    cur_lane = (d_tgt[..., None] - lanes).abs().argmin(dim=-1)
    direction = torch.where(draws.dir_u < 0.5, -1, 1)
    new_lane = torch.clamp(cur_lane + direction, 0, cfg.num_lanes - 1)
    d_tgt = torch.where(start, lanes[new_lane], d_tgt)
    d = d + torch.clamp(d_tgt - d, -LAT_RATE * cfg.dt, LAT_RATE * cfg.dt)

    s = s + v * cfg.dt
    behind = (s - ego[:, 0:1]) < BEHIND_CUTOFF
    new_s = ego[:, 0:1] + draws.spawn_s
    new_d = lanes[draws.spawn_lane]
    s = torch.where(behind, new_s, s)
    d = torch.where(behind, new_d, d)
    v = torch.where(behind, draws.spawn_v, v)
    d_tgt = torch.where(behind, new_d, d_tgt)
    v_cruise = torch.where(behind, draws.spawn_v, v_cruise)
    return torch.stack([s, d, v, d_tgt, v_cruise], dim=-1)


def _npc_heading(npcs: torch.Tensor) -> torch.Tensor:
    lat_rate = torch.clamp(npcs[..., 3] - npcs[..., 1], -LAT_RATE, LAT_RATE)
    return torch.atan2(lat_rate, torch.clamp(npcs[..., 2], min=1.0))


def _collision(ego: torch.Tensor, npcs: torch.Tensor) -> torch.Tensor:
    """Heading-aware OBB-vs-OBB separating-axis test -> (B,) bool."""
    ds = npcs[..., 0] - ego[:, 0:1]                          # (B, N)
    dd = npcs[..., 1] - ego[:, 1:2]
    phi = _npc_heading(npcs)

    def axes(theta):
        c, s_ = torch.cos(theta), torch.sin(theta)
        return torch.stack([c, s_], -1), torch.stack([-s_, c], -1)

    ea1, ea2 = axes(ego[:, 2:3])                             # (B, 1, 2)
    na1, na2 = axes(phi)                                     # (B, N, 2)
    delta = torch.stack([ds, dd], -1)
    e1, e2 = ea1.expand_as(na1), ea2.expand_as(na2)

    def sep(axis):
        ra = (CAR_HALF_LEN * (axis * e1).sum(-1).abs()
              + CAR_HALF_WID * (axis * e2).sum(-1).abs())
        rb = (CAR_HALF_LEN * (axis * na1).sum(-1).abs()
              + CAR_HALF_WID * (axis * na2).sum(-1).abs())
        return (delta * axis).sum(-1).abs() > ra + rb

    separated = sep(e1) | sep(e2) | sep(na1) | sep(na2)
    return (~separated).any(dim=-1)


def _lane_poly(road, ego, x):
    """Ego-frame lateral position of the road centerline at lookahead x (B, ...)."""
    s, d, mu = (_per_env(ego[:, i], x) for i in range(3))
    kap = curvature(road, s)
    kap_r = curvature_rate(road, s)
    return -d - mu * x + 0.5 * kap * x * x + (1.0 / 6.0) * kap_r * (x * x * x)


def _npc_ego_frame(road, ego, npcs):
    ds = npcs[..., 0] - ego[:, 0:1]
    x = ds * torch.cos(ego[:, 2:3])
    y = npcs[..., 1] + _lane_poly(road, ego, ds)
    return x, y


def _apply_fog(fog, img, dist):
    """Blend toward fog gray past each env's ``fog`` range; fog <= 0 is an
    exact identity (the sigmoid saturates to 1.0 at 1e9 m)."""
    eff = torch.where(fog > 0.0, fog, torch.full_like(fog, 1e9))
    vis = torch.sigmoid((_per_env(eff, dist) - dist) * 2.0)[..., None]
    color = torch.tensor(FOG_COLOR, device=img.device)
    return img * vis + color * (1.0 - vis)


def render_camera(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Ego-centric top-down RGB (B, H, W, 3); x in [0, 48 m], y in [-12, 12]."""
    h, w = cfg.image_hw
    dev = state.ego.device
    b = state.ego.shape[0]
    half_w = _road_half_width(cfg)
    xs = _linspace(48.0, 0.0, h, dev).reshape(1, h, 1)
    ys = _linspace(-12.0, 12.0, w, dev).reshape(1, 1, w)
    yc = _lane_poly(state.road, state.ego, xs.expand(b, h, 1))
    lat = ys - yc                                            # (B, H, W)
    on_road = (lat.abs() <= half_w).float()[..., None]
    img = 0.25 * on_road * torch.ones((h, w, 3), device=dev)
    img = img + 0.55 * (1 - on_road) * torch.tensor([0.1, 0.35, 0.1],
                                                    device=dev)
    bounds = _lane_centers(cfg, dev)[:-1] + cfg.lane_width / 2.0
    dist = (lat[..., None] - bounds).abs().min(dim=-1).values
    world_s = xs + _per_env(state.ego[:, 0], xs)
    dash = (torch.remainder(world_s, 4.0) < 2.0).float()
    marking = (dist < 0.3).float() * dash
    img = torch.clamp(img + marking[..., None] * 0.6, 0.0, 1.0)
    nx, ny = _npc_ego_frame(state.road, state.ego, state.npcs)  # (B, N)
    inx = torch.sigmoid((CAR_HALF_LEN - (xs[..., None] - nx[:, None, None, :])
                         .abs()) * 4.0)                         # (B, H, 1, N)
    iny = torch.sigmoid((CAR_HALF_WID - (ys[..., None] - ny[:, None, None, :])
                         .abs()) * 4.0)                         # (B, 1, W, N)
    npc_mask = torch.clamp((inx * iny).sum(-1), 0.0, 1.0)[..., None]
    img = img * (1 - npc_mask) + npc_mask * torch.tensor([0.85, 0.1, 0.1],
                                                         device=dev)
    ego_x = torch.sigmoid((CAR_HALF_LEN - (xs - 0.0).abs()) * 4.0)
    ego_y = torch.sigmoid((CAR_HALF_WID - (ys - 0.0).abs()) * 4.0)
    ego_mask = torch.clamp(ego_x * ego_y, 0.0, 1.0)[..., None]
    img = img * (1 - ego_mask) + ego_mask * torch.tensor([0.1, 0.85, 0.1],
                                                         device=dev)
    img = _apply_fog(state.fog, img, xs.expand(b, h, w))
    return img.float()


def render_camera_front(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Pinhole front camera at the ego (B, H, W, 3): height 1.5 m, looking
    along the ego heading; the ground plane coloured road / lanes / grass
    with the road band bent by the lane polynomial, NPCs as smooth
    billboards, fog by ground-plane depth (the sky sits at 1e6 m)."""
    h, w = cfg.image_hw
    dev = state.ego.device
    b = state.ego.shape[0]
    f, cam_h = 1.2, 1.5
    half_w = _road_half_width(cfg)
    u = _linspace(-1.0, 1.0, w, dev).reshape(1, 1, w)        # right positive
    v = _linspace(1.0, -1.0, h, dev).reshape(1, h, 1)        # top row = +1

    below = v < -1e-3
    depth = torch.where(below, f * cam_h / torch.clamp(-v, min=1e-3),
                        torch.full_like(v, 1e6))              # (1, H, 1)
    depth2d = depth.expand(b, h, w)
    lat = -u * depth2d / f                                    # left-positive
    road_lat = lat - _lane_poly(state.road, state.ego, depth2d)
    on_road = (road_lat.abs() <= half_w) & below
    grass = below & ~on_road
    sky = (~below).expand(b, h, w)

    def col(*rgb):
        return torch.tensor(rgb, device=dev)

    img = (sky[..., None] * col(0.45, 0.62, 0.85)
           + grass[..., None] * col(0.12, 0.35, 0.12)
           + on_road[..., None] * col(0.25, 0.25, 0.27))
    bounds = _lane_centers(cfg, dev)[:-1] + cfg.lane_width / 2.0
    dist = (road_lat[..., None] - bounds).abs().min(dim=-1).values
    dash = torch.remainder(_per_env(state.ego[:, 0], depth2d) + depth2d,
                           4.0) < 2.0
    marking = (dist < 0.15) & dash & on_road
    img = torch.where(marking[..., None], col(0.85, 0.85, 0.85), img)

    nx, ny = _npc_ego_frame(state.road, state.ego, state.npcs)  # (B, N)
    visible = (nx > 1.0).float()[:, None, None, :]
    xz = torch.clamp(nx, min=1.0)[:, None, None, :]             # (B,1,1,N)
    u_c = -f * ny[:, None, None, :] / xz
    u_half = f * (2 * CAR_HALF_WID) / xz
    v_bot = -f * cam_h / xz
    v_top = -f * (cam_h - 1.6) / xz                             # 1.6 m tall
    inu = torch.sigmoid((u_half - (u[..., None] - u_c).abs()) * 40.0)
    inv = (torch.sigmoid((v[..., None] - v_bot) * 40.0)
           * torch.sigmoid((v_top - v[..., None]) * 40.0))
    npc_m = inu * inv * visible                                 # (B,H,W,N)
    # Nearest (largest on screen) wins: weight by 1/x; near cars brighter.
    weight = npc_m * (1.0 / xz)
    total = torch.clamp(npc_m.sum(-1), 0.0, 1.0)
    shade = weight.sum(-1) / (npc_m.sum(-1) + 1e-6)
    car_col = torch.stack([0.6 + 8.0 * shade, 0.1 + 0.0 * shade,
                           0.1 + 0.0 * shade], dim=-1)
    img = (img * (1 - total[..., None])
           + torch.clamp(car_col, 0, 1) * total[..., None])
    img = _apply_fog(state.fog, img, depth2d)
    return torch.clamp(img, 0.0, 1.0).float()


def _curb_distance(cfg: EnvConfig, state: EnvState, dx, dy) -> torch.Tensor:
    """First road-boundary crossing along each ray (B, R); LIDAR_MAX_RANGE+1
    where a ray never leaves the road. Marches M static samples per ray and
    interpolates the first on-road -> off-road sign change."""
    m = _CURB_SAMPLES
    dev = dx.device
    ts = _linspace(0.0, LIDAR_MAX_RANGE, m + 1, dev)
    x = (ts[None, :] * dx[:, None])[None]                     # (1, R, M+1)
    y = (ts[None, :] * dy[:, None])[None]
    b = state.ego.shape[0]
    lat = y - _lane_poly(state.road, state.ego, x.expand(b, -1, -1))
    off = lat.abs() - _road_half_width(cfg)                   # > 0 off-road
    sample = torch.arange(m + 1, device=dev).expand_as(off)
    crossed = (off > 0.0) & (sample > 0)
    first = crossed & (torch.cumsum(crossed.int(), dim=-1) == 1)
    hit = first.any(dim=-1)
    i = torch.where(first, sample, 0).sum(-1)
    zero = torch.zeros((), device=dev)
    off_hi = torch.where(first, off, zero).sum(-1)
    prev = torch.nn.functional.pad(first[..., 1:], (0, 1))
    off_lo = torch.where(prev, off, zero).sum(-1)
    denom = off_hi - off_lo
    frac = torch.clamp(-off_lo / torch.where(denom == 0.0, 1.0, denom),
                       0.0, 1.0)
    dt = ts[1] - ts[0]
    t_hit = (i.float() - 1.0 + frac) * dt
    return torch.where(hit, t_hit, LIDAR_MAX_RANGE + 1.0)


def lidar_scan(cfg: EnvConfig, state: EnvState, rays: int = 0,
               max_range: Optional[torch.Tensor] = None):
    """Fixed ray fan vs NPC circles + curbs -> (points (B,R,4), mask (B,R)).

    ``rays`` overrides ``cfg.lidar_rays`` (the V2X roadside fan);
    ``max_range`` (B,) > 0 drops returns beyond it (fog)."""
    r = rays or cfg.lidar_rays
    dev = state.ego.device
    b = state.ego.shape[0]
    angles = _linspace(-math.pi / 2, math.pi / 2, r, dev)
    dx, dy = torch.cos(angles), torch.sin(angles)             # (R,)
    cx, cy = _npc_ego_frame(state.road, state.ego, state.npcs)  # (B, N)
    bb = dx[None, :, None] * cx[:, None, :] + dy[None, :, None] * cy[:, None, :]
    c = (cx * cx + cy * cy)[:, None, :] - NPC_RADIUS ** 2
    disc = bb * bb - c
    hit = (disc > 0) & (bb > 0)
    t = bb - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where(hit & (t > 0), t, LIDAR_MAX_RANGE + 1.0)
    t_npc = t.min(dim=-1).values                              # (B, R)
    if cfg.lidar_road:
        t_curb = _curb_distance(cfg, state, dx, dy)
        is_npc = t_npc <= t_curb
        t_min = torch.where(is_npc, t_npc, t_curb)
        z = torch.where(is_npc, _NPC_Z, _CURB_Z)
        inten = torch.where(is_npc, _NPC_INTENSITY, _CURB_INTENSITY)
    else:
        t_min = t_npc
        z = torch.full((b, r), _NPC_Z, device=dev)
        inten = torch.ones((b, r), device=dev)
    if max_range is None:
        max_range = torch.zeros((b,), device=dev)
    reach = torch.where(max_range > 0.0,
                        torch.clamp(max_range, max=LIDAR_MAX_RANGE),
                        LIDAR_MAX_RANGE)
    mask = t_min <= reach[:, None]
    t_safe = torch.where(mask, t_min, 0.0)
    pts = torch.stack([t_safe * dx, t_safe * dy, z, inten], dim=-1).float()
    return pts * mask[..., None], mask


def v2x_scan(cfg: EnvConfig, state: EnvState):
    """The roadside unit's scan (``cfg.v2x_rays`` rays): a virtual ego
    ``cfg.v2x_lookahead`` m ahead on the arc, at the road centre, heading 0,
    runs the ego's scan geometry. Points stay in the RSU frame. Not
    fog-limited: the mast sits above the fog layer."""
    zeros = torch.zeros_like(state.ego[:, 0])
    rsu = torch.stack([state.ego[:, 0] + cfg.v2x_lookahead, zeros, zeros,
                       zeros], dim=-1)
    return lidar_scan(cfg, state._replace(ego=rsu), rays=cfg.v2x_rays)


def observe(cfg: EnvConfig, state: EnvState):
    """(image (B,H,W,3), points (B,R,4), mask (B,R)) of every env. With
    ``cfg.v2x_rays`` the RSU's rays follow the ego's: R = lidar_rays +
    v2x_rays, one array for replay, the n-step window and PPO rollouts."""
    if cfg.camera_mode == "front":
        img = render_camera_front(cfg, state)
    else:
        img = render_camera(cfg, state)
    pts, mask = lidar_scan(cfg, state, max_range=state.fog)
    if cfg.v2x_rays > 0:
        v_pts, v_mask = v2x_scan(cfg, state)
        pts = torch.cat([pts, v_pts], dim=1)
        mask = torch.cat([mask, v_mask], dim=1)
    return img, pts, mask


# The JAX package's batched name; every function here is batched.
observe_batch = observe


def step(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
         draws: StepDraws):
    """One step of every env with auto-reset; action (B,) ints in [0, 9)."""
    steers, accels = action_table(state.ego.device)
    steer, accel = steers[action], accels[action]
    ego, s_dot = _dynamics(cfg, state.road, state.ego, steer, accel)
    npcs = _advance_npcs(cfg, state.npcs, ego, draws.npc)

    progress = s_dot * cfg.dt
    collided = _collision(ego, npcs)
    off_road = ego[:, 1].abs() > _road_half_width(cfg) - CAR_HALF_WID * 0.5
    lane_d = (ego[:, 1:2] - _lane_centers(cfg, ego.device)).abs().min(-1).values
    reward = (progress - 10.0 * collided.float() - 5.0 * off_road.float()
              - 0.05 * lane_d - 0.05 * ego[:, 2].abs())
    t = state.t + 1
    done = collided | off_road | (t >= cfg.max_steps)

    fresh = reset(cfg, draws.reset, fog=state.fog)
    nxt = EnvState(ego=ego, npcs=npcs, road=state.road, t=t, fog=state.fog)
    next_state = EnvState(*(
        torch.where(_per_env(done, a), a, b) for a, b in zip(fresh, nxt)))
    img, pts, mask = observe(cfg, next_state)
    ts = TimeStep(image=img, points=pts, mask=mask, reward=reward.float(),
                  done=done, info={"speed": ego[:, 3], "progress": progress})
    return next_state, ts


def reset_batch(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
                device="cuda") -> EnvState:
    dev = resolve_device(device)
    return reset(cfg, draw_reset(cfg, num_envs, generator, dev))


def step_batch(cfg: EnvConfig, states: EnvState, actions: torch.Tensor,
               generator: torch.Generator):
    draws = draw_step(cfg, states.ego.shape[0], generator, states.ego.device)
    return step(cfg, states, actions, draws)
