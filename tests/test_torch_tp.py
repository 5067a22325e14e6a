"""The port's tensor parallelism against the JAX package's specs and the
replicated run.

* Specs: ``runtime.tp.tp_param_shardings`` (JAX's ``_spec_for`` rule on each
  port parameter's flax path, ``bridge.flax_leaf``) equals JAX's
  ``tp_param_shardings`` carried over by the bridge's own name map
  (``bridge.key_map``), for the fused c4 ``QNetwork`` (only the MLPs and
  the pillar net split: the fused blocks' packed weights match no rule),
  arm B (q/k/v/o split by heads) and the ViT trunk.
* Numerics on gloo over 4 spawned ranks (``tests/torch_dist_ranks.py``):
  a ``FusionTransformer`` under TP at data 2 x model 2, its forward and
  one SGD step (gradients meaned over the data group) against the
  replicated run in this process within 1e-5 (JAX's
  ``tests/distributed/test_tp.py`` tolerances), every rank holding 1/2 of
  each split weight; the sharded c4 DQN iteration with its networks under
  TP against the same iteration without (a 2-rank pool), metrics within
  rtol 1e-5 / atol 1e-6 and parameters within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_c4_digital import flax_like
from multimodal_sc_torch import bridge
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.fusion.transformer import FusionTransformer
from multimodal_sc_torch.rl.perception import QNetwork
from multimodal_sc_torch.runtime import tp as ttp
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.rl import dqn as jdqn
from multimodal_sc_tpu.runtime import mesh as jmesh
from multimodal_sc_tpu.runtime.tp import tp_param_shardings as j_shardings

ATOL = 1e-5

ARMS = {"fused": [],
        "arm_b": ["pallas_mha_block=false", "pallas_attention=true"],
        "vit": ["camera.arch=vit", "pallas_attention=true"]}


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    p = ranks.RankPool(4, tmp_path_factory.mktemp("rendezvous4"))
    yield p
    p.close()


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_specs_equal_jax_tp_param_shardings(arm):
    over = ranks.TINY_C4 + ARMS[arm]
    jcfg = j_preset("c4").override_str(over)
    params = flax_like(jax.eval_shape(
        lambda k: jdqn.init_params(jcfg, k), jax.random.key(0)), 0)
    mesh = jmesh.make_mesh(data=4, model=2)
    want = {"/".join(str(k.key) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(
                j_shardings(params, mesh))}
    ndims = {"/".join(str(k.key) for k in path): leaf.ndim
             for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    net = QNetwork(t_preset("c4").override_str(over))
    names = bridge.key_map(params, net)
    got = ttp.tp_param_shardings(net)
    assert sorted(names.values()) == sorted(got)
    for path, key in names.items():
        assert got[key] == want[path], (path, key)
        # The inverse map the port reads its paths through.
        assert bridge.flax_leaf(net, key) == (path, ndims[path]), key
    split = {k for k, s in got.items() if s}
    assert any("mlp1" in k for k in split) and any("mlp2" in k for k in split)
    if arm == "fused":
        assert not any(k.endswith(("wq", "wk", "wv", "wo")) for k in split)
    else:
        assert any(k.endswith("q.weight") for k in split)
        assert any(k.endswith("o.weight") for k in split)


FUSION = {"fused": dict(cam_in=24, lid_in=40, dim=32, depth=2, heads=2,
                        state_dim=16),
          "arm_b": dict(cam_in=24, lid_in=40, dim=32, depth=2, heads=2,
                        state_dim=16, fused_block=False, use_pallas=True)}


@pytest.mark.parametrize("arm", sorted(FUSION))
def test_tp_forward_and_grad_step_match_the_replicated_run(pool4, arm):
    kw = FUSION[arm]
    torch.manual_seed(0)
    net = FusionTransformer(**kw)
    rng = np.random.default_rng(0)
    cam = rng.standard_normal((4, 8, 24)).astype(np.float32)
    lid = rng.standard_normal((4, 6, 40)).astype(np.float32)
    tgt = rng.standard_normal((4, 16)).astype(np.float32)
    sd = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    specs = ttp.tp_param_shardings(net)
    y = net(torch.tensor(cam), torch.tensor(lid))
    loss = (y - torch.tensor(tgt)).square().mean()
    params = list(net.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    with torch.no_grad():
        for p, g in zip(params, grads):
            if g is not None:
                p -= 1e-2 * g
    got = pool4.run("tp_fusion_step", sd=sd, cam=cam, lid=lid, tgt=tgt,
                    data=2, model=2, cfg_kw=kw)
    for r in got:
        np.testing.assert_allclose(r["y"], y.detach().numpy(), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), atol=ATOL,
                                       rtol=1e-4, err_msg=name)
            # A split weight holds half its rows (column-parallel) or
            # columns (row-parallel) on each rank.
            full = list(p.shape)
            if specs[name]:
                full[0 if specs[name][0] is None else 1] //= 2
            assert r["shapes"][name] == full, name
    assert sum(1 for s in specs.values() if s) >= (4 if arm == "fused" else 16)


@pytest.mark.parametrize("arm", ["fused", "arm_b"])
def test_sharded_dqn_under_tp_matches_it_without(pool4, tmp_path, arm):
    got = pool4.run("tp_dqn_iterations", iters=6, data=2, model=2,
                    extra=ARMS[arm])
    ref_pool = ranks.RankPool(2, tmp_path)
    try:
        ref = ref_pool.run("tp_dqn_iterations", iters=6, data=2, model=1,
                           extra=ARMS[arm])
    finally:
        ref_pool.close()
    assert got[0]["sharded"] >= 4
    for r in got:
        np.testing.assert_array_equal(r["params"], got[0]["params"])
        np.testing.assert_allclose(r["params"], ref[0]["params"], atol=ATOL)
        for m, w in zip(r["metrics"], ref[0]["metrics"]):
            for k in w:
                np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)


def test_apply_tp_refuses_indivisible_heads():
    from multimodal_sc_torch.runtime.mesh import Mesh

    mesh = Mesh(shape={"data": 1, "model": 4}, axis_names=("data", "model"),
                rank=0, data_index=0, model_index=0)
    net = FusionTransformer(**{**FUSION["arm_b"], "heads": 2})
    with pytest.raises(ValueError, match="heads 2 not divisible by model=4"):
        ttp.apply_tp(net, mesh)
