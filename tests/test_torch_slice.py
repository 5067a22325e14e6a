"""The c4 act path of the port, end to end, against the JAX package on the
CPU; and the port's package hygiene.

The Q-network runs at a reduced c4 (depth 1, narrow codecs; fusion dim 128
so the fused blocks stay kernel-eligible), with the JAX package's own
fresh parameters carried over by ``multimodal_sc_torch.bridge`` and JAX's
channel noise handed to the port.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import multimodal_sc_torch
from test_torch_c4_digital import flax_like
from multimodal_sc_torch import bridge, cli
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.envs import driving as tenv
from multimodal_sc_torch.io import export
from multimodal_sc_torch.rl import dqn as tdqn
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.envs import driving as jenv
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl.perception import QNetwork as JQNetwork

SMALL = ["fusion.depth=1", "camera.features=8,16,32,32", "camera.c_sym=4",
         "lidar.pillar_dim=16", "env.lidar_rays=16", "env.num_npcs=3",
         "rl.replay_capacity=64", "rl.n_step=2"]
PKG = pathlib.Path(multimodal_sc_torch.__file__).parent


def _configs(extra=()):
    over = SMALL + list(extra)
    # JAX side: the plain version of the fused blocks (interpret mode of the
    # kernel is the same function, and far slower on the CPU).
    jcfg = j_preset("c4").override_str(over + ["mha_block_kernel=false"])
    return jcfg, t_preset("c4").override_str(over)


def _jax_noise(cfg, key, batch):
    """The standard-normal draws the JAX trunk's two AWGN links make."""
    k_cam, k_lid = jax.random.split(key)
    hw = cfg.camera.image_hw
    n_cam = (hw[0] // 4) * (hw[1] // 4) * cfg.camera.c_sym
    n_lid = cfg.lidar.bev_hw[0] * cfg.lidar.bev_hw[1] * cfg.lidar.c_sym
    return tuple(torch.tensor(np.array(jax.random.normal(k, (batch, n, 2))))
                 for k, n in ((k_cam, n_cam), (k_lid, n_lid)))


@pytest.mark.parametrize("extra", [[], ["rl.ablate_lidar=true"]])
def test_qnetwork_matches_jax(extra):
    jcfg, tcfg = _configs(extra)
    states = jenv.reset_batch(jcfg.env, jax.random.key(5), 2)
    img, pts, mask = jenv.observe_batch(jcfg.env, states)
    net_key = jax.random.key(6)
    jnet = JQNetwork(jcfg)
    # JAX's tree drawn with numpy: its init compiles for tens of seconds.
    params = flax_like(jax.eval_shape(lambda k: jnet.init(
        k, img, pts, mask, net_key)["params"], jax.random.key(7)), 7)
    want = jax.jit(lambda p: jnet.apply({"params": p}, img, pts, mask,
                                        net_key))(params)

    tnet = TQNetwork(tcfg)
    tnet.load_state_dict(bridge.to_state_dict(params, tnet))
    with torch.no_grad():
        got = tnet(torch.tensor(np.array(img)), torch.tensor(np.array(pts)),
                   torch.tensor(np.array(mask)),
                   channel_noise=_jax_noise(jcfg, net_key, 2))
    # f32 through ~20 layers, summed in other orders: 1e-4.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert (got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).all()


def test_act_only_iterations_match_jax_bookkeeping():
    """Two act-only iterations from a bridged JAX state: the same replay
    cursor/size, window fill, uint8 frames, metric keys, and the replay
    rows that do not depend on the (random) actions."""
    jcfg, tcfg = _configs()
    num_envs = 4
    js = jdqn.init(jcfg, jax.random.key(0), num_envs)
    it = jdqn.make_iteration(jcfg, learn=False)
    for _ in range(2):
        js, jm = it(js)

    ts = tdqn.init(tcfg, seed=0, num_envs=num_envs, device="cpu")
    j0 = jdqn.init(jcfg, jax.random.key(0), num_envs)
    ts.params.load_state_dict(bridge.to_state_dict(j0.params, ts.params))
    ts = ts._replace(env_states=bridge.env_state_from_jax(j0.env_states,
                                                          device="cpu"),
                     obs_image=torch.tensor(np.array(j0.obs_image)),
                     obs_points=torch.tensor(np.array(j0.obs_points)),
                     obs_mask=torch.tensor(np.array(j0.obs_mask)))
    it_t = tdqn.make_iteration(tcfg, learn=False)
    for _ in range(2):
        ts, tm = it_t(ts)

    assert set(tm) == set(jm)
    assert ts.buffer.cursor == int(js.buffer.cursor) == num_envs
    assert ts.buffer.size == int(js.buffer.size) == num_envs
    assert ts.window.fill == int(js.window.fill)
    assert ts.window.cursor == int(js.window.cursor)
    assert float(tm["epsilon"]) == float(jm["epsilon"])
    assert float(tm["buffer_size"]) == float(jm["buffer_size"])
    assert ts.obs_image.dtype == torch.uint8
    assert ts.buffer.data.image.dtype == torch.uint8
    assert ts.buffer.data.next_image.dtype == torch.uint8
    # The first transitions start at the bridged observation.
    np.testing.assert_array_equal(ts.buffer.data.image[:num_envs].numpy(),
                                  np.asarray(js.buffer.data.image[:num_envs]))
    np.testing.assert_allclose(ts.buffer.data.points[:num_envs].numpy(),
                               np.asarray(js.buffer.data.points[:num_envs]),
                               atol=1e-4, rtol=1e-5)
    for k in tm:
        assert torch.isfinite(tm[k]).all(), k


def test_learn_mode_raises():
    """The learner is ported for the analog trunk and both digital links;
    what raises now is what JAX's config validation refuses on the RL
    path: HARQ with token pruning, a damage selection rule."""
    _, tcfg = _configs()
    tdqn.make_iteration(tcfg, learn=True)
    tdqn.make_iteration(tcfg.override_str(["camera.arch=vq"]), learn=True)
    digital = tcfg.override_str(["lidar.arch=vq", "lidar.vq_prune=true"])
    tdqn.make_iteration(digital.validate(), learn=True)
    with pytest.raises(ValueError, match="harq with token pruning"):
        digital.override_str(["channel.harq=true"]).validate()
    with pytest.raises(ValueError, match="content-free selection"):
        digital.override_str(["channel.token_keep=0.5",
                              "channel.token_select=drop_damage"]).validate()


def test_no_jax_in_the_port():
    banned = ("jax", "flax", "optax", "multimodal_sc_tpu")
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_preset("c4")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdqn.init(cfg, num_envs=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdqn.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenv.reset_batch(cfg.env, 2, torch.Generator())
    j_state = jenv.reset(j_preset("c4").env, jax.random.key(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.env_state_from_jax(j_state)
    # The front door: a CLI verb without --device, the api's train and an
    # artifact's load (before it reads anything).
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--config", "c1", "--set", "train.steps=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multimodal_sc_torch.api.train(t_preset("c1"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_artifact("no-such-artifact")
    assert multimodal_sc_torch.resolve_device("cpu").type == "cpu"
