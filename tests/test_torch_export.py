"""Deployment export (``multimodal_sc_torch/io/export.py``) on the CPU: each
``torch.export`` artifact, saved and loaded back with ``load_artifact``
alone, reproduces the live module at batch sizes other than the one it was
traced at (codecs within 1e-5, indices and actions exactly), refuses
inputs of another shape or dtype, and, given bridged weights, the codec
encoders and the ideal-channel policy agree with the JAX package's
``encode`` / ``encode_tokens`` and its portable ``QNetwork``. The CLI's
``export`` verb: ``--use-ema`` serializes the EMA network, ``--batch``
fixes the size, and a codec without a checkpoint exports its fresh
weights with a warning.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_c4_digital import flax_like
from multimodal_sc_torch import bridge
from multimodal_sc_torch import cli as tcli
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import driving as tenv
from multimodal_sc_torch.io import export as export_lib
from multimodal_sc_torch.io.checkpoint import CheckpointManager
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl import ppo as tppo
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.io import export as jexport
from multimodal_sc_tpu.rl.perception import QNetwork as JQNetwork
from multimodal_sc_tpu.train import fusion_jscc as jfj
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

TINY4 = ["camera.features=8,16,16,16", "camera.c_sym=2",
         "camera.image_hw=16,16", "env.image_hw=16,16", "lidar.pillar_dim=16",
         "lidar.c_sym=2", "lidar.bev_hw=8,8", "fusion.dim=32",
         "fusion.depth=1", "fusion.heads=2", "fusion.state_dim=32",
         "env.num_npcs=2", "env.lidar_rays=16", "rl.replay_capacity=16",
         "rl.batch_size=4"]
LIDAR = ["lidar.pillar_dim=16", "lidar.c_sym=2", "lidar.bev_hw=8,8",
         "lidar.max_points=64", "lidar.max_pillars=32"]
CODECS = {
    # name: (preset, overrides, camera or LiDAR)
    "camera_cnn_seg": ("c2", ["camera.features=8,16,16,16", "camera.c_sym=2",
                              "camera.image_hw=16,16"], "camera"),
    # The digital codecs re-seed in training: their exports leave the
    # re-seeding statistics out.
    "camera_vq": ("c1", ["camera.arch=vq", "camera.vq_codes=64",
                         "camera.vq_dim=16", "camera.features=8,16,16,16",
                         "camera.image_hw=16,16", "camera.vq_reseed=0.5"],
                  "camera"),
    "lidar_analog": ("c3", LIDAR, "lidar"),
    "lidar_vq": ("c3", LIDAR + ["lidar.arch=vq", "lidar.vq_codes=16",
                                "lidar.vq_dim=8", "lidar.vq_reseed=0.5"],
                 "lidar"),
}
SIZES = (3, 5)      # traced at export_lib.TRACE_BATCH = 2


def _t(x):
    return torch.tensor(np.array(x))


def _round_trip(parts, cfg, path):
    export_lib.save_artifact(str(path), parts, cfg)
    return export_lib.load_artifact(str(path), device="cpu")


def _camera_inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    h, w = cfg.camera.image_hw
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    return img, rng.uniform(-5, 25, b).astype(np.float32)


def _lidar_inputs(b, seed):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 52, (b, 64)), rng.uniform(-14, 14, (b, 64)),
                    rng.uniform(0, 1.8, (b, 64)), rng.uniform(0, 1, (b, 64))],
                   -1).astype(np.float32)
    return pts, rng.uniform(0, 1, (b, 64)) < 0.9, rng.uniform(
        -5, 25, b).astype(np.float32)


def _codec(name):
    """The JAX codec, its (numpy-drawn) parameters and the port's module on
    them."""
    preset, over, kind = CODECS[name]
    jcfg, tcfg = (j_preset(preset).override_str(over),
                  t_preset(preset).override_str(over))
    if kind == "camera":
        jm, tm = jjscc.build_model(jcfg), tjscc.build_model(tcfg)
        img, snr = _camera_inputs(jcfg, 2, 0)
        args = (img, snr)
    else:
        jm, tm = jfj.build_lidar_codec(jcfg), tfj.build_lidar_codec(tcfg)
        pts, mask, snr = _lidar_inputs(2, 0)
        args = (pts, mask, snr) if jcfg.lidar.arch == "vq" else (
            (pts, mask), snr)
    # The digital codecs' init runs their link: it takes a key.
    vq = len(args) == 3 or jcfg.camera.arch == "vq" and kind == "camera"
    params = flax_like(jax.eval_shape(
        lambda k: jm.init(k, *args, *((k,) if vq else ()))["params"],
        jax.random.key(0)), 1)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    return jcfg, tcfg, jm, params, tm.eval(), kind


@pytest.mark.parametrize("name", sorted(CODECS))
def test_codec_artifact_reproduces_the_live_codec_and_jax(name, tmp_path):
    jcfg, tcfg, jm, params, tm, kind = _codec(name)
    if kind == "camera":
        parts = export_lib.export_camera_codec(tcfg, tm)
        vq = tcfg.camera.arch == "vq"
        seg = ["decoder_seg"] if tcfg.camera.seg_classes > 0 and not vq else []
        assert sorted(parts) == sorted(["encoder", "decoder"] + seg)
    else:
        parts = export_lib.export_lidar_codec(tcfg, tm)
        vq = tcfg.lidar.arch == "vq"
        assert sorted(parts) == ["lidar_decoder", "lidar_encoder"]
    fns = _round_trip(parts, tcfg, tmp_path)
    enc, dec = (fns["encoder"], fns["decoder"]) if kind == "camera" else (
        fns["lidar_encoder"], fns["lidar_decoder"])
    for b in SIZES:
        if kind == "camera":
            img, snr = _camera_inputs(tcfg, b, b)
            x = (_t(img),) if vq else (_t(img), _t(snr))
        else:
            pts, mask, snr = _lidar_inputs(b, b)
            x = (_t(pts), _t(mask)) if vq else (_t(pts), _t(mask), _t(snr))
        with torch.no_grad():
            z = enc(*x)
            if vq:
                live = (tm.encode_tokens(*x)[0] if kind == "lidar"
                        else tm.encode_tokens(x[0])[0])
                assert z.dtype == torch.int32
                assert torch.equal(z, live)
                rec, live_rec = dec(z), tm.decode_tokens(z)
            else:
                live = (tm.encode(x[0], x[1]) if kind == "camera"
                        else tm.encode((x[0], x[1]), x[2]))
                torch.testing.assert_close(z, live, atol=1e-5, rtol=1e-5)
                rec, live_rec = dec(z, x[-1]), tm.decode(z, x[-1])
            torch.testing.assert_close(rec, live_rec, atol=1e-5, rtol=1e-5)
            if "decoder_seg" in fns:
                got, want = fns["decoder_seg"](z, x[-1]), tm.decode_seg(
                    z, x[-1])
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
                assert got[1].shape == (b, 16, 16, tcfg.camera.seg_classes)
    # The encoder against JAX's, on the last batch.
    if kind == "camera":
        want = (jm.apply({"params": params}, x[0].numpy(),
                         method="encode_tokens")[0] if vq else
                jm.apply({"params": params}, x[0].numpy(), x[1].numpy(),
                         method="encode"))
    else:
        want = (jm.apply({"params": params}, x[0].numpy(), x[1].numpy(),
                         method="encode_tokens")[0] if vq else
                jm.apply({"params": params}, (x[0].numpy(), x[1].numpy()),
                         x[2].numpy(), method="encode"))
    if vq:
        np.testing.assert_array_equal(z.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(z.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


POLICIES = {
    "dqn": ("c4", []),
    "ppo": ("c5", []),
    # The digital camera link under Type-I HARQ: data-dependent rounds.
    "dqn_vq_harq": ("c4", ["camera.arch=vq", "camera.vq_codes=16",
                           "camera.vq_dim=8", "channel.harq=true"]),
}


def _obs(cfg, b, seed):
    states = tenv.reset_batch(cfg.env, b, torch.Generator().manual_seed(seed),
                              "cpu")
    return tenv.observe_batch(cfg.env, states)


@pytest.fixture(scope="module")
def dqn_artifact(tmp_path_factory):
    cfg = t_preset("c4").override_str(TINY4)
    net = tdqn.init_params(cfg, 0, "cpu").eval()
    fns = _round_trip({"policy": export_lib.export_policy(cfg, net)}, cfg,
                      tmp_path_factory.mktemp("dqn"))
    return cfg, net, fns["policy"]


def _greedy(cfg, net, obs, seed):
    """The live network's greedy actions, its links drawing from the
    default generator seeded ``seed``."""
    with torch.no_grad(), torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        out = net(*obs)
    return (out[0] if cfg.rl.algo == "ppo" else out).argmax(-1)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_artifact_takes_the_live_greedy_actions(name, dqn_artifact,
                                                       tmp_path):
    if name == "dqn":
        cfg, net, policy = dqn_artifact
    else:
        preset, over = POLICIES[name]
        cfg = t_preset(preset).override_str(TINY4 + over).validate()
        lib = tppo if cfg.rl.algo == "ppo" else tdqn
        net = lib.init_params(cfg, 0, "cpu").eval()
        policy = _round_trip({"policy": export_lib.export_policy(cfg, net)},
                             cfg, tmp_path)["policy"]
    rng_state = torch.random.get_rng_state()
    for b, seed in zip(SIZES, (7, 123)):
        obs = _obs(cfg, b, b)
        a = policy(*obs, seed)
        assert a.dtype == torch.int32 and a.shape == (b,)
        assert torch.equal(a.long(), _greedy(cfg, net, obs, seed))
    # The caller's generator is left as it was.
    assert torch.equal(torch.random.get_rng_state(), rng_state)


def test_artifact_refuses_another_shape_or_dtype(dqn_artifact):
    cfg, _, policy = dqn_artifact
    img, pts, mask = _obs(cfg, 3, 0)
    with pytest.raises(Exception):
        policy(img[:, :8], pts, mask, 0)            # image height
    with pytest.raises(Exception):
        policy(img.double(), pts, mask, 0)          # dtype
    with pytest.raises(Exception):
        policy(img, pts[:2], mask[:2], 0)           # batch not shared


def test_policy_on_the_ideal_channel_matches_jax(tmp_path):
    """Bridged weights, the ideal channel (no draws on either side): the
    artifact takes the greedy actions of JAX's live portable route."""
    over = TINY4 + ["channel.kind=ideal"]
    jcfg, tcfg = (j_preset("c4").override_str(over),
                  t_preset("c4").override_str(over))
    pcfg = jexport._portable(jcfg)
    jnet = JQNetwork(pcfg)
    img, pts, mask = jenv.observe_batch(jcfg.env, jenv.reset_batch(
        jcfg.env, jax.random.key(3), 6))
    params = flax_like(jax.eval_shape(lambda k: jnet.init(
        k, img, pts, mask, k)["params"], jax.random.key(0)), 5)
    q_fn = jax.jit(lambda p: jnet.apply({"params": p}, img, pts, mask,
                                        jax.random.key(0)))
    # The Q head's bias less each action's mean over the batch: the greedy
    # actions then follow what differs between the observations.
    q0 = q_fn(params)
    params = {**params, "q": {**params["q"],
                              "bias": params["q"]["bias"] - q0.mean(0)}}
    want = np.argmax(np.asarray(q_fn(params)), axis=-1)
    assert len(set(want.tolist())) > 1
    net = tdqn.init_params(tcfg, 0, "cpu")
    net.load_state_dict(bridge.to_state_dict(params, net))
    policy = _round_trip({"policy": export_lib.export_policy(tcfg, net)},
                         tcfg, tmp_path)["policy"]
    np.testing.assert_array_equal(policy(_t(img), _t(pts), _t(mask), 0)
                                  .numpy(), want)


def _bias_towards(net, action):
    with torch.no_grad():
        net.q.bias.zero_()
        net.q.bias[action] = 1e3


def test_cli_export_use_ema_exports_the_ema_network(tmp_path):
    ckpt = tmp_path / "ck"
    over = TINY4 + [f"train.checkpoint_dir={ckpt}"]
    cfg = t_preset("c4").override_str(over)
    state = tdqn.init(cfg, seed=0, num_envs=2, device="cpu")
    _bias_towards(state.params, 5)
    _bias_towards(state.ema_params, 3)
    mgr = CheckpointManager(str(ckpt))
    mgr.save(1, state)
    mgr.close()
    out = tmp_path / "artifact"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["export", "--config", "c4", "--use-ema", "--out",
                          str(out), "--device", "cpu"]
                         + [a for o in over for a in ("--set", o)]) == 0
    printed = json.loads(buf.getvalue())
    assert printed["parts"] == ["policy"] and printed["bytes"]["policy"] > 0
    policy = export_lib.load_artifact(str(out), device="cpu")["policy"]
    obs = _obs(cfg, 4, 1)
    assert policy(*obs, 11).tolist() == [3] * 4
    assert _greedy(cfg, state.params, obs, 11).tolist() == [5] * 4


def test_cli_export_c1_without_a_checkpoint(tmp_path, capsys):
    """Fresh weights with a warning; ``--batch 2`` fixes the size; the
    manifest names the parts, the platforms, torch's version and the
    format."""
    over = ["camera.features=8,16,16,16", "train.batch_size=2"]
    out = tmp_path / "artifact"
    assert tcli.main(["export", "--config", "c1", "--batch", "2", "--out",
                      str(out), "--device", "cpu"]
                     + [a for o in over for a in ("--set", o)]) == 0
    assert "exporting UNTRAINED params" in capsys.readouterr().err
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest == {"parts": ["decoder", "encoder"],
                        "platforms": ["cpu", "cuda"],
                        "torch_version": torch.__version__,
                        "format": "torch.export/pt2"}
    assert json.loads((out / "config.json").read_text())["name"] == \
        "c1_jscc_awgn"
    fns = export_lib.load_artifact(str(out), device="cpu")
    cfg = t_preset("c1").override_str(over)
    fresh = tjscc.create_train_state(cfg, cfg.train.seed, "cpu").params
    img = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    snr = torch.full((2,), 10.0)
    with torch.no_grad():
        torch.testing.assert_close(fns["encoder"](img, snr),
                                   fresh.encode(img, snr), atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(Exception):
        fns["encoder"](torch.cat([img, img[:1]]), torch.full((3,), 10.0))
