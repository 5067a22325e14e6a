"""The port's JSCC -> RL warm start against the JAX package on the CPU.

A JAX c1 ``CameraJSCC``, a c1 ``ViTJSCC`` and a c3 ``LateFusionJSCC`` are
built and saved with JAX's ``CheckpointManager``, and a JAX perception is
warm-started from each. The same source parameters are bridged into the
port, saved with the port's manager, and the port's perception (the same
fresh parameters, bridged) is warm-started from that: every trunk
parameter must be equal, and so must the loaded and the skipped lists.
"""

import re
import warnings

import jax
import numpy as np
import pytest

from test_torch_c4_digital import flax_like
from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.io.checkpoint import CheckpointManager as TManager
from multimodal_sc_torch.rl.perception import QNetwork as TQNetwork
from multimodal_sc_torch.rl.warmstart import load_jscc_into_perception as tws
from multimodal_sc_torch.train import fusion_jscc as tfj
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.io.checkpoint import CheckpointManager as JManager
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.rl.warmstart import load_jscc_into_perception as jws
from multimodal_sc_tpu.train import fusion_jscc as jfj
from multimodal_sc_tpu.train import jscc as jjscc

CAM = ["camera.features=8,16,16,16", "camera.c_sym=2",
       "camera.image_hw=16,16", "camera.dim=32", "camera.depth=2",
       "camera.heads=2"]
LID = ["lidar.pillar_dim=16", "lidar.c_sym=2", "lidar.bev_hw=8,8"]
RL = CAM + LID + ["env.image_hw=16,16", "fusion.dim=32", "fusion.depth=1",
                  "fusion.heads=2", "fusion.state_dim=32", "env.num_npcs=2",
                  "env.lidar_rays=16"]
# (JSCC preset, its overrides, the RL trunk's camera arch)
SOURCES = {
    "c1_cnn": ("c1", CAM, "cnn"),
    "c1_vit": ("c1", CAM + ["camera.arch=vit"], "vit"),
    # A ViT camera into a CNN trunk: the camera is skipped, the LiDAR loads.
    "c3": ("c3", CAM + LID + ["lidar.max_points=64"], "cnn"),
}


def _skipped(caught):
    """The skipped list a warm start's warning names, [] without one."""
    for w in caught:
        m = re.search(r"warm-start skipped (\[[^\]]*\])", str(w.message))
        if m:
            return m.group(1)
    return "[]"


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_warm_start_matches_jax(tmp_path, source):
    preset, over, arch = SOURCES[source]
    j_src = j_preset(preset).override_str(over)
    t_src = t_preset(preset).override_str(over)
    jlib, tlib = (jfj, tfj) if preset == "c3" else (jjscc, tjscc)
    jstate = jlib.create_train_state(j_src, jax.random.key(1))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    mgr = JManager(jdir)
    mgr.save(5, jstate, wait=True)
    mgr.close()
    tstate = tlib.create_train_state(t_src, 0, "cpu")
    tstate.params.load_state_dict(
        bridge.to_state_dict(jstate.params, tstate.params))
    TManager(tdir).save(5, tstate)

    rl_over = RL + [f"camera.arch={arch}"]
    j_rl, t_rl = (j_preset("c4").override_str(rl_over),
                  t_preset("c4").override_str(rl_over))
    # JAX's tree drawn with numpy: its init compiles for tens of seconds.
    fresh = flax_like(jax.eval_shape(lambda k: jdqn.init_params(j_rl, k),
                                     jax.random.key(2)), 2)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want, j_loaded = jws(j_rl, fresh, jdir, return_loaded=True)
    net = TQNetwork(t_rl)
    net.load_state_dict(bridge.to_state_dict(fresh, net))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got, t_loaded = tws(t_rl, net, tdir, return_loaded=True)
    assert got is net
    assert t_loaded == j_loaded and t_loaded
    assert _skipped(tw) == _skipped(jw)
    if source == "c3":
        assert _skipped(tw) == "['cam_enc']"
    want = bridge.to_state_dict(want, net)
    for name, p in net.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want[name].numpy(),
                                      err_msg=name)


def test_warm_start_refusals(tmp_path):
    t_rl = t_preset("c4").override_str(RL)
    net = TQNetwork(t_rl)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tws(t_rl, net, str(tmp_path))
    # A source with nothing that maps: a ViT camera into a CNN trunk alone.
    src = t_preset("c1").override_str(CAM + ["camera.arch=vit"])
    TManager(str(tmp_path)).save(1, tjscc.create_train_state(src, 0, "cpu"))
    with pytest.raises(ValueError, match="mapped nothing"):
        tws(t_rl, net, str(tmp_path))
    # A digital LiDAR trunk: still nothing maps from that source.
    digital = t_rl.override_str(["lidar.arch=vq"])
    with pytest.raises(ValueError, match="mapped nothing"):
        tws(digital, TQNetwork(digital), str(tmp_path))
