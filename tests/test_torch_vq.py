"""The port's VQ camera codec (c1_vq) against the JAX package on the CPU.

* ``vector_quantize``: the losses (with and without the usage term), the
  straight-through gradients to the features and the codebook, the usage
  counts and the re-seeding candidates, on inputs with no ties (the order
  of ``torch.topk`` among tied errors is unspecified), 1e-5;
* ``VQCameraJSCC`` on bridged weights given JAX's channel draws, uncoded
  and under both Hamming decoders: the reconstruction, the aux values and
  the gradients of MSE + VQ loss, 1e-5;
* the fresh codebook draw, and the properties of the port's own
  ``seed_codebook`` and ``reseed_dead_codes`` draws (the port draws from a
  ``torch.Generator``, so their values are not JAX's);
* c1_vq train steps held step by step to JAX's (AdamW under the warm-up
  schedule, the dead-code re-seeding after each step given JAX's coin);
* one point of each sweep, the ``eval`` command's VQ branches, and the
  refusals the JAX package keeps.

16x16 images (16 tokens of 4 bits, a whole number of bytes for FEC),
features (8, 8, 16, 16), 16 codes of dimension 8; f32, TF32 off.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sc_torch import bridge
from multimodal_sc_torch.codec import semantic_vq as tvq
from multimodal_sc_torch.config import get_preset as t_preset
from multimodal_sc_torch.evaluation import snr_sweep as tsweep
from multimodal_sc_torch.train import jscc as tjscc
from multimodal_sc_tpu.codec import semantic_vq as jvq
from multimodal_sc_tpu.config import get_preset as j_preset
from multimodal_sc_tpu.evaluation import snr_sweep as jsweep
from multimodal_sc_tpu.train import jscc as jjscc

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

VQ = ["camera.arch=vq", "camera.image_hw=16,16", "camera.features=8,8,16,16",
      "camera.vq_codes=16", "camera.vq_dim=8", "train.batch_size=2"]
BATCH = 2
N_TOK, N_BITS = 16, 4


def _configs(extra=()):
    over = VQ + list(extra)
    return j_preset("c1").override_str(over), t_preset("c1").override_str(over)


def _t(x):
    return torch.tensor(np.array(x))


def _perturb(tree, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), tree)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5, err_msg=err_msg)


@pytest.mark.parametrize("usage,rows", [(0.0, 48), (0.3, 48), (0.0, 5)])
def test_vector_quantize_matches_jax(usage, rows):
    """Losses, both gradients and the re-seeding stats; ``rows`` 5 < 16
    codes tiles the candidates up to K as JAX does."""
    rng = np.random.default_rng(rows)
    z = rng.standard_normal((rows, 8)).astype(np.float32)
    cb = rng.standard_normal((16, 8)).astype(np.float32)
    w = rng.standard_normal((rows, 8)).astype(np.float32)

    def jloss(z, cb):
        zs, idx, loss, stats = jvq.vector_quantize(
            z, cb, 0.25, usage_coef=usage, with_stats=True)
        return jnp.sum(zs * w) + loss, (idx, loss, stats)

    (_, (jidx, jl, jstats)), (jgz, jgcb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))
    tz = torch.tensor(z, requires_grad=True)
    tcb = torch.tensor(cb, requires_grad=True)
    zs, idx, loss, stats = tvq.vector_quantize(tz, tcb, 0.25,
                                               usage_coef=usage,
                                               with_stats=True)
    ((zs * torch.from_numpy(w)).sum() + loss).backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32
    _close(float(loss.detach()), float(jl))
    _close(tz.grad, jgz, "d/dz")
    _close(tcb.grad, jgcb, "d/dcodebook")
    np.testing.assert_array_equal(stats["counts"].numpy(),
                                  np.asarray(jstats["counts"]))
    np.testing.assert_array_equal(stats["candidates"].numpy(),
                                  np.asarray(jstats["candidates"]))
    z_ste, idx2, loss2 = tvq.vector_quantize(tz, tcb, 0.25, usage)
    assert torch.equal(idx2, idx) and float(loss2) == float(loss)


@functools.lru_cache(maxsize=None)
def _jax_model(extra=()):
    jcfg, _ = _configs(extra)
    model = jjscc.build_model(jcfg)
    img = jnp.zeros((BATCH, 16, 16, 3))
    params = jax.jit(lambda k: model.init(
        k, img, jnp.full((BATCH,), 10.0), jax.random.key(0))["params"])(
            jax.random.key(3))
    return jcfg, model, _perturb(params, 4)


def _port(params, extra=()):
    _, tcfg = _configs(extra)
    tm = tjscc.build_model(tcfg)
    tm.load_state_dict(bridge.to_state_dict(params, tm))
    return tm


def _n_sym(fec):
    bits = N_TOK * N_BITS
    return (bits * 7 // 4 if fec != "none" else bits) // 2


@pytest.mark.parametrize("fec", ["none", "hamming74", "hamming74_soft"])
def test_vq_camera_jscc_matches_jax_given_its_draws(fec):
    """The forward at 1 dB (index errors on the link, so the decoder sees
    received codes that differ from the sent ones) and the gradients of
    MSE + VQ loss: the encoder's through the clean straight-through path,
    the codebook's through the VQ loss alone."""
    extra = (f"channel.fec={fec}",)
    jcfg, model, params = _jax_model(extra)
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.uniform(0, 1, (BATCH, 16, 16, 3)), jnp.float32)
    snr = jnp.full((BATCH,), 1.0, jnp.float32)
    key = jax.random.key(9)

    def jloss(p):
        recon, aux = model.apply({"params": p}, img, snr, key)
        return jnp.mean(jnp.square(recon - img)) + aux["vq_loss"], (recon,
                                                                    aux)

    (jl, (jrecon, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    assert float(jaux["index_error_rate"]) > 0
    tm = _port(params, extra)
    noise = _t(jax.random.normal(key, (BATCH, _n_sym(fec), 2)))
    timg = _t(img)
    recon, aux = tm(timg, _t(snr), noise=noise)
    loss = (recon - timg).square().mean() + aux["vq_loss"]
    loss.backward()
    _close(recon.detach(), jrecon, "recon")
    _close(float(loss), float(jl))
    for k in ("vq_loss", "index_error_rate", "code_perplexity"):
        _close(float(aux[k]), float(jaux[k]), k)
    want = bridge.to_state_dict(jgrads, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)


def test_transmit_and_decode_halves_match_jax():
    jcfg, model, params = _jax_model()
    tm = _port(params)
    img = np.random.default_rng(6).uniform(0, 1, (BATCH, 16, 16, 3)).astype(
        np.float32)
    jidx, jl, jz = model.apply({"params": params}, jnp.asarray(img),
                               method="encode_tokens")
    idx, loss, z = tm.encode_tokens(torch.from_numpy(img))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(float(loss), float(jl))
    _close(z.detach(), jz)
    jrec = model.apply({"params": params}, jidx, method="decode_tokens")
    _close(tm.decode_tokens(idx).detach(), jrec)
    assert tm.n_tokens == N_TOK and tm.bits_per_image == N_TOK * N_BITS


def test_fresh_codebook_draws_as_flax():
    """flax's ``variance_scaling(1, "fan_in", "uniform")`` on a (K, D)
    codebook takes fan_in = K: U(+-sqrt(3 / K)); the port's draw has its
    bounds and its spread."""
    _, tcfg = _configs(["camera.vq_codes=256", "camera.vq_dim=64"])
    torch.manual_seed(0)
    cb = tjscc.build_model(tcfg).codebook.detach()
    jcb = jax.nn.initializers.variance_scaling(1.0, "fan_in", "uniform")(
        jax.random.key(0), (256, 64))
    limit = np.sqrt(3.0 / 256)
    assert float(cb.abs().max()) <= limit
    assert float(jnp.max(jnp.abs(jcb))) <= limit
    assert abs(float(cb.std()) / float(jnp.std(jcb)) - 1.0) < 0.05
    assert float(cb.abs().max()) > 0.95 * limit


@pytest.mark.parametrize("rows", [64, 10])
def test_seed_codebook_rows_come_from_the_features(rows):
    """Every seeded row is a feature row plus N(0, 0.01^2) jitter; without
    replacement (distinct rows) when there are at least K rows."""
    g = torch.Generator().manual_seed(0)
    z = torch.randn((rows, 8), generator=g) * 3.0
    cb = torch.zeros((16, 8))
    out = tvq.seed_codebook(cb, z.reshape(2, rows // 2, 8), g)
    assert out is cb
    nearest = torch.cdist(cb, z).argmin(dim=1)
    jitter = cb - z[nearest]
    assert float(jitter.abs().max()) < 0.06
    assert 0.005 < float(jitter.std()) < 0.015
    if rows >= 16:
        assert len(set(nearest.tolist())) == 16


def test_reseed_moves_only_dead_codes():
    g = torch.Generator().manual_seed(1)
    cb = torch.randn((16, 8), generator=g)
    cand = torch.randn((16, 8), generator=g)
    counts = torch.tensor([0, 3, 0, 1] * 4, dtype=torch.int32)
    coin = torch.linspace(0.0, 0.95, 16)
    new, n = tvq.reseed_dead_codes(cb, counts, cand, rate=0.5, coin=coin)
    take = (counts == 0) & (coin < 0.5)
    assert int(n) == int(take.sum()) > 0
    assert torch.equal(new[take], cand[take])
    assert torch.equal(new[~take], cb[~take])
    jnew, jn = jvq.reseed_dead_codes(
        jnp.asarray(cb.numpy()), jnp.asarray(counts.numpy()),
        jnp.asarray(cand.numpy()), jax.random.key(0), 1.0)
    new1, n1 = tvq.reseed_dead_codes(cb, counts, cand, g, 1.0)
    assert int(n1) == int(jn) == 8
    np.testing.assert_array_equal(new1.numpy(), np.asarray(jnew))


def test_train_steps_follow_jax():
    """Four steps from the same weights (the first at the warm-up's lr 0)
    with JAX's draws, the dead codes re-seeded after each step with JAX's
    coin: loss, metrics and every parameter after every step."""
    over = ["train.steps=6", "train.warmup_steps=2", "camera.vq_reseed=0.5",
            "camera.vq_usage_coef=0.1"]
    jcfg, tcfg = _configs(over)
    model = jjscc.build_model(jcfg)
    jstate = jax.jit(lambda k: jjscc.create_train_state(jcfg, k))(
        jax.random.key(0))
    jstate = jstate.replace(params=_perturb(jstate.params, 2))
    body = jax.jit(jjscc._step_body(jcfg, model))
    state = tjscc.create_train_state(tcfg, 0, "cpu")
    tm = state.params
    tm.load_state_dict(bridge.to_state_dict(jstate.params, tm))
    t_step = tjscc.make_train_step(tcfg)
    rng = np.random.default_rng(3)
    reseeded = 0.0
    for step in range(4):
        img = rng.uniform(0, 1, (BATCH, 16, 16, 3)).astype(np.float32)
        key = jax.random.fold_in(jax.random.key(7), step)
        jstate, jm = body(jstate, jnp.asarray(img), None, key)
        _, kch = jax.random.split(key)
        draws = tjscc.StepDraws(
            channel=_t(jax.random.normal(kch, (BATCH, _n_sym("none"), 2))),
            coin=_t(jax.random.uniform(jax.random.fold_in(key, 0xD0D0),
                                       (16,))))
        state, m = t_step(state, _t(img), draws)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{step} {k}")
        want = bridge.to_state_dict(jstate.params, tm)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-5, err_msg=f"{step} {name}")
        reseeded += float(m["vq_reseeded"])
    assert reseeded > 0 and state.step == 4


def test_sweep_points_match_jax():
    """One point of each sweep. Over the ideal channel and at 25 dB (no
    index errors, one HARQ round for every block) both packages are
    deterministic, so the PSNR, the index errors and the HARQ accounting
    must agree."""
    jcfg, model, params = _jax_model()
    tm = _port(params)
    img = np.random.default_rng(8).uniform(0, 1, (BATCH, 16, 16, 3)).astype(
        np.float32)
    _, tcfg = _configs()
    kw = dict(snrs_db=(25.0,), batches_per_point=1)
    want = jsweep.sweep_camera_vq(jcfg, params, jnp.asarray(img),
                                  jax.random.key(0), kinds=("ideal",), **kw)
    got = tsweep.sweep_camera_vq(tcfg, tm, torch.from_numpy(img),
                                 kinds=("ideal", "awgn"), **kw)
    for kind in ("ideal", "awgn"):
        for k, v in want["ideal"][0].items():
            np.testing.assert_allclose(got[kind][0][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{kind} {k}")
    want = jsweep.sweep_camera_vq_harq(jcfg, params, jnp.asarray(img),
                                       jax.random.key(0), kinds=("awgn",),
                                       **kw)
    got = tsweep.sweep_camera_vq_harq(tcfg, tm, torch.from_numpy(img),
                                      kinds=("awgn",), **kw)
    assert set(got["awgn"][0]) == set(want["awgn"][0])
    for k, v in want["awgn"][0].items():
        np.testing.assert_allclose(got["awgn"][0][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert got["awgn"][0]["mean_rounds"] == 1.0
    low = tsweep.sweep_camera_vq_harq(tcfg, tm, torch.from_numpy(img),
                                      snrs_db=(-4.0,), kinds=("awgn",),
                                      batches_per_point=2)
    assert low["awgn"][0]["mean_rounds"] > 1.0
    assert (low["awgn"][0]["symbols_per_item"]
            > got["awgn"][0]["symbols_per_item"])


def test_eval_command_vq_branches(tmp_path, capsys):
    """The ``eval`` command (the dataset's 32x32 images) on a VQ
    checkpoint: the plain sweep with FEC
    riding ``--set channel.fec``, ``--harq-sweep`` with its table, the
    curves written; ``--keep-sweep`` on a codec trained without pruning
    returns 2 with the JAX package's message."""
    over = ["--set", "camera.arch=vq",
            "--set", "camera.features=8,8,16,16", "--set",
            "camera.vq_codes=16", "--set", "camera.vq_dim=8", "--set",
            "train.batch_size=2", "--device", "cpu", "--allow-untrained",
            "--kinds", "awgn"]
    out = tmp_path / "c.json"
    assert tsweep.main(["--config", "c1", "--harq-sweep", "--out", str(out)]
                       + over) == 0
    text = capsys.readouterr().out
    assert "sym/img" in text and "rounds" in text
    curves = json.loads(out.read_text())
    assert len(curves["awgn"]) == 7
    assert tsweep.main(["--config", "c1", "--set",
                        "channel.fec=hamming74_soft", "--out", str(out)]
                       + over) == 0
    rows = json.loads(out.read_text())["awgn"]
    assert [r["snr_db"] for r in rows] == list(range(-5, 26, 5))
    assert set(rows[0]) == {"snr_db", "psnr", "ssim", "index_err"}
    assert tsweep.main(["--config", "c1", "--keep-sweep"] + over) == 2
    assert "--keep-sweep requires camera.vq_prune=true" in (
        capsys.readouterr().err)


@pytest.mark.parametrize("over,exc,match", [
    (["channel.uep_alpha=0.5"], None, None),
    (["camera.vq_prune=true"], None, None),
    (["channel.uep_alpha=0.5", "camera.vq_prune=true"], ValueError,
     "uep_alpha with camera.vq_prune"),
    (["camera.image_hw=4,12", "channel.fec=hamming74"], ValueError,
     "divisible by 8"),
    (["camera.vq_codes=32"], ValueError, "power of 4"),
])
def test_vq_refusals(over, exc, match):
    """UEP and token pruning each build (the pruned codec with its
    ``mask_embed``); together, and the FEC and codebook-size cases, they
    refuse as the JAX package does."""
    _, tcfg = _configs(over)
    if exc is None:
        model = tjscc.build_model(tcfg)
        assert hasattr(model, "mask_embed") == tcfg.camera.vq_prune
        return
    with pytest.raises(exc, match=match):
        tjscc.build_model(tcfg)


def test_driver_seeds_a_fresh_codebook_and_resumes(tmp_path):
    """A fresh VQ run (the dataset's 32x32 images) seeds its codebook from
    the fresh encoder's outputs on a batch of seed + 777 (every row a
    feature row plus jitter; the warm-up's learning rate is 0, then lr /
    100); the metrics carry JAX's keys; a resumed run restores the trained
    codebook instead of seeding again."""
    from multimodal_sc_torch.envs.datasets import ImageDataset

    _, tcfg = _configs(["camera.image_hw=32,32", "train.steps=2",
                        "train.warmup_steps=100", "train.eval_every=2",
                        "train.log_every=1",
                        f"train.checkpoint_dir={tmp_path}",
                        "train.checkpoint_every=1"])
    fresh = tjscc.create_train_state(tcfg, 0, "cpu").params
    with torch.no_grad():
        z = fresh.encode_features(next(ImageDataset(
            tcfg.train.dataset, BATCH, seed=777, device="cpu")))
    state, out = tjscc.run(tcfg, device="cpu")
    assert {"loss", "psnr", "vq_loss", "index_error_rate", "code_perplexity",
            "eval_psnr"} <= set(out)
    cb = state.params.codebook.detach().clone()
    gap = torch.cdist(cb, z.reshape(-1, 8)).min(dim=1).values
    assert float(gap.max()) < 0.1
    assert float((cb - fresh.codebook.detach()).abs().max()) > 0.1
    again, _ = tjscc.run(tcfg.override_str(["train.steps=3"]), device="cpu")
    assert again.step == 3
    assert float((again.params.codebook.detach() - cb).abs().max()) < 1e-3
