"""The port's ring and Ulysses attention against the JAX package's.

JAX runs ``ring_attention`` / ``ulysses_attention`` on the 8-device CPU
mesh of ``tests/conftest.py``; the port runs them on gloo over 4 spawned
ranks (``tests/torch_dist_ranks.py``), as a data axis of 4 (4 x 1) and of
2 (2 x 2: both model ranks of a data index hold the same block) and, in
this process, as a ring of one rank. Same inputs from a numpy seed; the
outputs of every block and the gradients of q, k and v (through the
collectives' own backward) gathered. Tolerances are JAX's own test's:
2e-5 on outputs, 1e-3 on gradients.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from multimodal_sc_torch.kernels import ring_attention as tring
from multimodal_sc_torch.kernels.attention import attention_reference
from multimodal_sc_torch.runtime.mesh import make_mesh
from multimodal_sc_tpu.kernels.ring_attention import (ring_attention,
                                                      shard_sequence,
                                                      ulysses_attention)

OUT_TOL, GRAD_TOL = 2e-5, 1e-3   # tests/distributed/test_ring_attention.py


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = ranks.RankPool(4, tmp_path_factory.mktemp("rendezvous"))
    yield p
    p.close()


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax(kind, mesh8, q, k, v, go):
    fn = ring_attention if kind == "ring" else ulysses_attention
    qs, ks, vs = (shard_sequence(jnp.asarray(a), mesh8) for a in (q, k, v))
    out = fn(qs, ks, vs, mesh8)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, mesh8) * jnp.asarray(go))

    grads = jax.grad(loss, argnums=(0, 1, 2))(qs, ks, vs)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("shape", [(2, 8, 64, 16), (1, 8, 128, 32)])
def test_matches_jax_on_the_8_device_mesh(pool, mesh8, kind, shape):
    q, k, v, go = _inputs(shape)
    want, want_grads = _jax(kind, mesh8, q, k, v, go)
    for data, model in ((4, 1), (2, 2)):
        got = pool.run("ring_job", q=q, k=k, v=v, kind=kind, grad_out=go,
                       data=data, model=model)
        for r in got:
            assert r["local_shape"][2] == shape[2] // data
            np.testing.assert_allclose(r["out"], want, atol=OUT_TOL,
                                       rtol=OUT_TOL)
            for name, w in zip(("dq", "dk", "dv"), want_grads):
                np.testing.assert_allclose(r[name], w, atol=GRAD_TOL,
                                           rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_a_ring_of_one_rank_is_plain_attention(kind):
    q, k, v, go = (torch.tensor(a) for a in _inputs((1, 2, 32, 16), 1))
    fn = tring.ring_attention if kind == "ring" else tring.ulysses_attention
    mesh = make_mesh()
    assert torch.equal(tring.shard_sequence(q, mesh), q)
    qg = q.clone().requires_grad_(True)
    out = fn(qg, k, v, mesh)
    ref_q = q.clone().requires_grad_(True)
    ref = attention_reference(ref_q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=OUT_TOL, rtol=OUT_TOL)
    out.backward(go)
    ref.backward(go)
    np.testing.assert_allclose(qg.grad.numpy(), ref_q.grad.numpy(),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ulysses_rejects_indivisible_heads(pool, mesh8):
    q = jnp.zeros((1, 3, 64, 16))
    with pytest.raises(ValueError, match="divisible") as jax_err:
        ulysses_attention(q, q, q, mesh8)
    got = pool.run("ulysses_heads_error", heads=3)
    assert all(m == "heads 3 not divisible by axis size 4" for m in got)
    assert str(jax_err.value) == "heads 3 not divisible by axis size 8"


def test_flash_accumulators_merge_as_jax():
    # The package re-exports the function under the module's name.
    jring = importlib.import_module("multimodal_sc_tpu.kernels.ring_attention")
    rng = np.random.default_rng(2)
    q, k1, k2, v1, v2 = (rng.standard_normal((1, 2, 8, 4)).astype(np.float32)
                         for _ in range(5))
    want = jring._merge(jring._block_attention_stats(q, k1, v1, 0.5),
                        jring._block_attention_stats(q, k2, v2, 0.5))
    t = [torch.tensor(a) for a in (q, k1, k2, v1, v2)]
    got = tring._merge(tring._block_attention_stats(t[0], t[1], t[3], 0.5),
                       tring._block_attention_stats(t[0], t[2], t[4], 0.5))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    assert tring._NEG == jring._NEG
