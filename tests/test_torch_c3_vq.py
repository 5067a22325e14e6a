"""c3_vq (the digital LiDAR codec trained with the analog ViT camera) and
c1_vq_prune / c1_vq UEP training of the port against the JAX package on the
CPU, with their sweeps and the ``eval`` command's new branches.

* four c3_vq train steps with dead-code re-seeding, pruning off and on,
  given JAX's draws (the camera noise, the kept fractions, the random
  selection scores, the LiDAR link noise, the coin): the loss and metrics
  (1e-4 relative, 1e-5 absolute) and every parameter after every step;
* two c1_vq steps pruned (random selection at JAX's kept fractions) and
  two under UEP (the damage probes JAX draws), held the same way;
* a fresh c3_vq run seeds its LiDAR codebook from its encoder; two steps,
  a save, a resume and two more equal four straight, bit for bit, with the
  pruned codec's ``mask_embed`` in the checkpoint;
* one point of each new sweep against JAX's (deterministic: the ideal
  channel, or 25 dB, and the content-free ``scatter`` rule);
* the ``eval`` command's ``--keep-sweep`` (camera and BEV) and
  ``--entropy-sweep`` write their curves, and refuse as JAX does.

Reduced widths: a 16x16 ViT of depth 1 (dim 32, 2 heads, XLA attention in
JAX, the plain version in the port), an 8x8 BEV from 64 points, 16 codes of
dimension 8, batch 2; f32, TF32 off. Parameters are held to 1e-5.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec import lidar_bev as tlid
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.evaluation import snr_sweep as tsweep
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
import multimodal_sc_tpu.codec.semantic_vq  # noqa: F401
from multimodal_sc_tpu.codec import lidar_bev as jlid
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.evaluation import snr_sweep as jsweep
from multimodal_sc_tpu.train import fusion_jscc as jfj
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

C3 = ["camera.image_hw=16,16", "camera.depth=1", "camera.dim=32",
      "camera.heads=2", "camera.c_sym=4", "lidar.pillar_dim=16",
      "lidar.max_points=64", "lidar.bev_hw=8,8", "lidar.arch=vq",
      "lidar.vq_codes=16", "lidar.vq_dim=8", "lidar.vq_usage_coef=0.25",
      "lidar.vq_reseed=0.5", "train.batch_size=2"]
VQ = ["camera.arch=vq", "camera.image_hw=16,16", "camera.features=8,8,16,16",
      "camera.vq_codes=16", "camera.vq_dim=8", "train.batch_size=2",
      "train.steps=6", "train.warmup_steps=1"]
BATCH, N_TOK, N_BEV = 2, 16, 64


def _t(x):
    return torch.tensor(np.array(x))


def _perturb(tree, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _points(rng):
    pts = np.stack([rng.uniform(-4, 52, (BATCH, 64)),
                    rng.uniform(-14, 14, (BATCH, 64)),
                    rng.uniform(0, 1.8, (BATCH, 64)),
                    rng.uniform(0, 1, (BATCH, 64))], -1).astype(np.float32)
    mask = rng.uniform(0, 1, (BATCH, 64)) < 0.9
    cls = rng.integers(1, 4, (BATCH, 64)).astype(np.int32)
    return pts, mask, cls


def _hold(step, metrics, jmetrics, module, jparams):
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {step}: {k}")
    want = bridge.to_state_dict(jparams, module)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=f"step {step}: {name}")


@functools.lru_cache(maxsize=None)
def _c3_jax(prune):
    over = C3 + [f"lidar.vq_prune={str(prune).lower()}"]
    jcfg = j_preset("c3").override_str(over)
    jstate = jfj.create_train_state(jcfg, jax.random.key(0))
    return jcfg, jstate.replace(params=_perturb(jstate.params, 1)), \
        jfj.make_train_step(jcfg)


@pytest.mark.parametrize("prune", [False, True])
def test_c3_vq_train_steps_follow_jax(prune):
    jcfg, jstate, j_step = _c3_jax(prune)
    tcfg = t_preset("c3").override_str(
        C3 + [f"lidar.vq_prune={str(prune).lower()}"])
    state = tfj.create_train_state(tcfg, 0, "cpu")
    state.params.load_state_dict(bridge.to_state_dict(jstate.params,
                                                      state.params))
    t_step = tfj.make_train_step(tcfg)
    rng = np.random.default_rng(2)
    n_cam = (16 // 4) ** 2 * jcfg.camera.c_sym
    reseeded = 0.0
    for step in range(4):
        img = rng.uniform(0, 1, (BATCH, 16, 16, 3)).astype(np.float32)
        pts, mask, cls = _points(rng)
        key = jax.random.fold_in(jax.random.key(3), step)
        jstate, jm = j_step(jstate, img, pts, mask, cls, key)
        _, kch = jax.random.split(key)
        k_cam, k_lid = jax.random.split(kch)
        lid = jcfg.lidar
        draws = tfj.StepDraws(
            channel_noise=(
                _t(jax.random.normal(k_cam, (BATCH, n_cam, 2))),
                _t(jax.random.normal(k_lid, (BATCH, N_BEV * 2, 2)))),
            keep=_t(jax.random.uniform(
                jax.random.fold_in(key, 0x6EEA), (BATCH,),
                minval=lid.vq_keep_min, maxval=1.0)) if prune else None,
            select=_t(jax.random.uniform(jax.random.fold_in(k_lid, 88),
                                         (BATCH, N_BEV))) if prune else None,
            coin=_t(jax.random.uniform(jax.random.fold_in(key, 0xD0D0),
                                       (lid.vq_codes,))))
        state, m = t_step(state, *(torch.from_numpy(a) for a in (
            img, pts, mask, cls)), draws)
        _hold(step, m, jm, state.params, jstate.params)
        reseeded += float(m["lidar_vq_reseeded"])
    assert state.step == 4 and reseeded > 0
    assert ("lidar_token_keep_frac" in m) == prune


@pytest.mark.parametrize("mode", ["prune", "uep"])
def test_c1_vq_prune_and_uep_steps_follow_jax(mode):
    extra = (["camera.vq_prune=true"] if mode == "prune"
             else ["channel.uep_alpha=0.25", "channel.snr_db=1.0"])
    jcfg = j_preset("c1").override_str(VQ + extra)
    tcfg = t_preset("c1").override_str(VQ + extra)
    model = jjscc.build_model(jcfg)
    jstate = jax.jit(lambda k: jjscc.create_train_state(jcfg, k))(
        jax.random.key(0))
    jstate = jstate.replace(params=_perturb(jstate.params, 4))
    body = jax.jit(jjscc._step_body(jcfg, model))
    state = tjscc.create_train_state(tcfg, 0, "cpu")
    state.params.load_state_dict(bridge.to_state_dict(jstate.params,
                                                      state.params))
    t_step = tjscc.make_train_step(tcfg)
    rng = np.random.default_rng(5)
    for step in range(2):
        img = rng.uniform(0, 1, (BATCH, 16, 16, 3)).astype(np.float32)
        key = jax.random.fold_in(jax.random.key(6), step)
        jstate, jm = body(jstate, jnp.asarray(img), None, key)
        _, kch = jax.random.split(key)
        draws = tjscc.StepDraws(channel=_t(jax.random.normal(
            kch, (BATCH, N_TOK * 2, 2))))
        if mode == "prune":
            draws = draws._replace(
                keep=_t(jax.random.uniform(
                    jax.random.fold_in(key, 0x6EE9), (BATCH,),
                    minval=jcfg.camera.vq_keep_min, maxval=1.0)),
                select=_t(jax.random.uniform(jax.random.fold_in(kch, 88),
                                             (BATCH, N_TOK))))
        else:
            draws = draws._replace(uep=_t(jax.random.normal(
                jax.random.fold_in(kch, 77), (2, BATCH, 16, 16, 3))))
        state, m = t_step(state, _t(img), draws)
        _hold(step, m, jm, state.params, jstate.params)
    assert ("token_keep_frac" in m) == (mode == "prune")


def _run_cfg(tmp_path, steps, prune=True):
    over = C3 + [f"lidar.vq_prune={str(prune).lower()}",
                 "camera.image_hw=32,32", "train.dataset=synthetic_cifar",
                 f"train.steps={steps}", "train.log_every=1",
                 "train.checkpoint_every=2"]
    if tmp_path is not None:
        over.append(f"train.checkpoint_dir={tmp_path}")
    return t_preset("c3").override_str(over)


def test_c3_vq_run_seeds_its_codebook_and_resumes_bit_equal(tmp_path):
    fresh = tfj.create_train_state(_run_cfg(None, 0), 0, "cpu")
    cb0 = fresh.params.lidar.codebook.detach().clone()
    seeded = tfj.seed_lidar_codebook(_run_cfg(None, 0), fresh.params, "cpu")
    assert float((seeded - cb0).abs().max().detach()) > 0.05
    state0, _ = tfj.run(_run_cfg(None, 0), device="cpu")
    assert torch.equal(state0.params.lidar.codebook, seeded)
    straight, out = tfj.run(_run_cfg(None, 4), device="cpu")
    assert {"lidar_vq_loss", "lidar_index_err", "lidar_code_perplexity",
            "lidar_vq_reseeded", "lidar_token_keep_frac"} <= set(out)
    half, _ = tfj.run(_run_cfg(tmp_path, 2), device="cpu")
    resumed, _ = tfj.run(_run_cfg(tmp_path, 4), device="cpu")
    assert resumed.step == 4
    for (name, p), q in zip(straight.params.named_parameters(),
                            resumed.params.parameters()):
        assert torch.equal(p, q), name
    assert "lidar.mask_embed" in dict(resumed.params.named_parameters())
    assert not torch.equal(half.params.lidar.mask_embed,
                           resumed.params.lidar.mask_embed)


# --- the sweeps -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bev_pair(extra=()):
    """A pruned c3_vq's LiDAR parameters and the port's codec on them,
    with the point cloud and its class grid."""
    jcfg, jstate, _ = _c3_jax(True)
    jcfg = jcfg.override_str(list(extra))
    tcfg = t_preset("c3").override_str(C3 + ["lidar.vq_prune=true"]
                                       + list(extra))
    params = jstate.params["lidar"]
    tm = tfj.build_lidar_codec(tcfg)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    pts, mask, cls = _points(np.random.default_rng(7))
    lid = jcfg.lidar
    target = jlid.semantic_bev_target(jnp.asarray(pts), jnp.asarray(mask),
                                      jnp.asarray(cls), lid.bev_hw,
                                      lid.x_range, lid.y_range, 4)
    return jcfg, tcfg, params, tm, (pts, mask, target)


def _both(fn_j, fn_t, data, **kw):
    pts, mask, target = data
    want = fn_j(jnp.asarray(pts), jnp.asarray(mask), target,
                jax.random.key(0), **kw)
    got = fn_t(_t(pts), _t(mask), _t(target), **kw)
    return want, got


def _equal_rows(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_bev_sweep_points_equal_jax():
    """``sweep_lidar_vq`` (ideal, and AWGN at 25 dB), ``sweep_lidar_vq_keep``
    (``scatter`` at 0.5 and 1) and ``sweep_lidar_vq_entropy`` (the
    calibration, and the three deployments over the ideal channel)."""
    jcfg, tcfg, params, tm, data = _bev_pair(("channel.kind=ideal",))
    kw = dict(snrs_db=(25.0,), batches_per_point=1)
    want, got = _both(
        lambda *a, **k: jsweep.sweep_lidar_vq(jcfg, params, *a, **k),
        lambda *a, **k: tsweep.sweep_lidar_vq(tcfg, tm, *a, **k), data,
        kinds=("ideal", "awgn"), **kw)
    for kind in ("ideal", "awgn"):
        _equal_rows(got[kind][0], want[kind][0])
        assert got[kind][0]["index_err"] == 0.0
    want, got = _both(
        lambda *a, **k: jsweep.sweep_lidar_vq_keep(jcfg, params, *a, **k),
        lambda *a, **k: tsweep.sweep_lidar_vq_keep(tcfg, tm, *a, **k), data,
        keeps=(0.5, 1.0), selects=("scatter",), batches_per_point=1)
    for g, w in zip(got["scatter"], want["scatter"]):
        _equal_rows(g, w)
    assert got["scatter"][0]["keep_frac_actual"] == 0.5
    want, got = _both(
        lambda *a, **k: jsweep.sweep_lidar_vq_entropy(jcfg, params, *a, **k),
        lambda *a, **k: tsweep.sweep_lidar_vq_entropy(tcfg, tm, *a, **k),
        data, kinds=("ideal",), keep_codes=4, **kw)
    _equal_rows(got["calibration"], want["calibration"])
    _equal_rows(got["ideal"][0], want["ideal"][0])
    assert got["ideal"][0]["syms_vlc"] < got["ideal"][0]["syms_full"]


def test_camera_keep_sweep_point_equals_jax():
    over = VQ + ["camera.vq_prune=true", "channel.kind=ideal"]
    jcfg = j_preset("c1").override_str(over)
    tcfg = t_preset("c1").override_str(over)
    model = jjscc.build_model(jcfg)
    params = _perturb(jax.jit(lambda k: model.init(
        k, jnp.zeros((BATCH, 16, 16, 3)), jnp.full((BATCH,), 10.0),
        jax.random.key(0))["params"])(jax.random.key(8)), 9)
    tm = tjscc.build_model(tcfg)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    img = np.random.default_rng(10).uniform(0, 1, (BATCH, 16, 16, 3)).astype(
        np.float32)
    kw = dict(keeps=(0.25, 1.0), selects=("scatter",), batches_per_point=1)
    want = jsweep.sweep_camera_vq_keep(jcfg, params, jnp.asarray(img),
                                       jax.random.key(0), **kw)
    got = tsweep.sweep_camera_vq_keep(tcfg, tm, _t(img), **kw)
    for g, w in zip(got["scatter"], want["scatter"]):
        _equal_rows(g, w)


def _c3_args(extra=(), base=C3):
    over = list(base) + ["camera.image_hw=32,32",
                         "train.dataset=synthetic_cifar"] + list(extra)
    return [a for o in over for a in ("--set", o)] + [
        "--device", "cpu", "--allow-untrained", "--kinds", "awgn"]


def test_eval_command_keep_and_entropy_branches(tmp_path, capsys):
    """The c3 ``eval`` branches on a digital LiDAR codec: ``--keep-sweep``
    on a pruned codec (4 rules x 7 fractions), ``--entropy-sweep`` (its
    calibration and 7 SNRs), the plain sweep's index-error table; the
    refusals return 2 with JAX's messages; the camera ``--keep-sweep``
    writes its curves."""
    out = tmp_path / "c.json"
    assert tsweep.main(["--config", "c3", "--keep-sweep", "--out", str(out)]
                       + _c3_args(["lidar.vq_prune=true"])) == 0
    curves = json.loads(out.read_text())
    assert set(curves) == {"scatter", "random", "drop_damage",
                           "drop_damage_scatter"}
    assert [r["keep"] for r in curves["random"]] == list(
        tsweep.DEFAULT_KEEPS)
    assert tsweep.main(["--config", "c3", "--entropy-sweep", "--out",
                        str(out)] + _c3_args()) == 0
    curves = json.loads(out.read_text())
    assert {"calibration", "awgn"} == set(curves)
    assert len(curves["awgn"]) == 7 and "miou_vlc" in curves["awgn"][0]
    assert tsweep.main(["--config", "c3", "--out", str(out)]
                       + _c3_args()) == 0
    assert "lidar index error rate" in capsys.readouterr().out
    assert set(json.loads(out.read_text())["lidar"]["awgn"][0]) == {
        "snr_db", "miou", "index_err"}
    assert tsweep.main(["--config", "c3", "--keep-sweep"] + _c3_args()) == 2
    assert "requires lidar.vq_prune=true" in capsys.readouterr().err
    analog = [o for o in C3 if not o.startswith("lidar.")]
    assert tsweep.main(["--config", "c3", "--entropy-sweep"]
                       + _c3_args(base=analog)) == 2
    assert "requires lidar.arch=vq" in capsys.readouterr().err
    cam = ["--set", "camera.arch=vq", "--set", "camera.vq_prune=true",
           "--set", "camera.features=8,8,16,16", "--set",
           "camera.vq_codes=16", "--set", "camera.vq_dim=8", "--set",
           "train.batch_size=2", "--device", "cpu", "--allow-untrained"]
    assert tsweep.main(["--config", "c1", "--keep-sweep", "--out", str(out)]
                       + cam) == 0
    assert "drop_damage/psnr" in capsys.readouterr().out
    assert len(json.loads(out.read_text())["drop_damage"]) == 7


def test_lidar_vq_codec_parameter_names_match_jax():
    """The bridge carries every parameter of JAX's ``LidarBEVVQCodec``
    (``pfn``, ``backbone``, ``to_code``, ``codebook``, ``from_code``,
    ``mask_embed``, ``dec_backbone``, ``occ_head``) and nothing else."""
    *_, params, tm, _ = _bev_pair()
    assert set(params) == {"pfn", "backbone", "to_code", "codebook",
                           "from_code", "mask_embed", "dec_backbone",
                           "occ_head"}
    assert {n.split(".")[0] for n, _ in tm.named_parameters()} == set(params)
    assert isinstance(tm, tlid.LidarBEVVQCodec)
