"""The port's KD training against the JAX package on the CPU, on the same
numpy params and token blocks: the straight-through sign and the latent
BitLinear, the losses, the learning-rate schedule, the forward's training
extras and whole KD train steps (``make_train_step``) in fp32.

Tolerances: values and gradients to 1e-5 of their largest magnitude (fp32
sums in other orders). Updated params: ``‖got − want‖ ≤ 1e-5 ‖want‖`` per
leaf, and g and h also element by element to 1e-5 of their largest value.
The latent weights are not held element by element: Adam divides each
gradient by its own magnitude plus eps = 1e-8, so where a gradient lies
near 0 the update ``g / (|g| + eps)`` turns fp32 summation noise of
``1e-10`` into a change of up to 1e-2 of the learning rate; some hundred of
the tiny config's 5e5 latent values move so (measured 3e-4 of the largest
latent), while the leaf as a whole stays within 3e-6. The gradients
themselves are held element by element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_tpu.core import bitlinear as jcore
from onebit_tpu.core.build_start import build_start_params as jbuild
from onebit_tpu.kernels import bitlinear as jbl
from onebit_tpu.model import bitllama as jb
from onebit_tpu.model.config import BitLlamaConfig as JaxConfig
from onebit_tpu.train import losses as jlosses
from onebit_tpu.train import trainer as jt
from onebit_tpu_torch.convert import params_from_jax, params_to_numpy
from onebit_tpu_torch.core import bitlinear as tcore
from onebit_tpu_torch.core.packing import device_to_kmajor
from onebit_tpu_torch.kernels import bitlinear as tbl
from onebit_tpu_torch.model import bitllama as tb
from onebit_tpu_torch.model.config import BitLlamaConfig
from onebit_tpu_torch.train import losses as tlosses
from onebit_tpu_torch.train import trainer as tt

TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * max(top, 1e-30), (what, err, top)


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


# ---------------------------------------------------------------------------
# the straight-through sign and the latent BitLinear
# ---------------------------------------------------------------------------

def test_sign_ste_matches_jax():
    (w,) = _rng_arrays(0, (40, 24), scale=1.5)
    w[0, :5] = 0.0
    (gout,) = _rng_arrays(1, (40, 24))
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tcore.sign_ste(tw)
    out.backward(torch.from_numpy(gout))
    jout, vjp = jax.vjp(jcore.sign_ste, jnp.asarray(w))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    assert (out.detach()[0, :5] == 0).all()
    _close(tw.grad, vjp(jnp.asarray(gout))[0])
    assert tcore.STE_SLOPE_OFFSET == jcore.STE_SLOPE_OFFSET


@pytest.mark.parametrize("bias", [False, True])
def test_latent_bitlinear_matches_jax(bias):
    """Forward and gradients of x, the latent weight, g, h (and the bias)
    through ``bitlinear_apply`` in the latent mode, fp32; the raw stacked
    projection of the same weights."""
    x, lat, g, h, b, gout = _rng_arrays(2, (3, 5, 64), (48, 64), (64,),
                                        (48,), (48,), (3, 5, 48))
    g, h = 1 + 0.3 * g, 1 + 0.3 * h
    names = ["x", "latent", "g", "h"] + (["bias"] if bias else [])
    arrays = [x, lat * 0.01, g, h] + ([b] if bias else [])

    def jfn(x, lat, g, h, *bb):
        w = jbl.BitLinearWeights(weight_scale=h, input_factor=g, latent=lat,
                                 bias=bb[0] if bb else None)
        return jbl.bitlinear_apply(x, w)

    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(gout))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    w = tbl.BitLinearWeights(weight_scale=ts[3], input_factor=ts[2],
                             latent=ts[1], bias=ts[4] if bias else None)
    assert w.mode == "latent"
    out = tbl.bitlinear_apply(ts[0], w)
    out.backward(torch.from_numpy(gout))
    _close(out, jout, what="out")
    for name, t, wg in zip(names, ts, want):
        _close(t.grad, wg, what=name)

    stacked = tbl.BitLinearWeights(*(None if a is None else a.detach()[None]
                                     for a in w))
    jw = jbl.BitLinearWeights(*(None if a is None else jnp.asarray(
        a.numpy()) for a in stacked))
    _close(tbl.bitlinear_apply_stacked_raw(ts[0].detach(), stacked, 0),
           jbl.bitlinear_apply_stacked_raw(jnp.asarray(x), jw, 0),
           what="raw")


def test_latent_bitlinear_bf16_forward():
    """bf16: x⊙g rounded to bf16, the product and the LayerNorm in fp32 and
    the output rounded to bf16 on both sides: equal to within one bf16 ulp
    of the largest output (2**-7 of the top binade)."""
    x, lat, g, h = _rng_arrays(3, (4, 128), (96, 128), (128,), (96,))
    g = 1 + 0.3 * g
    jw = jbl.BitLinearWeights(weight_scale=jnp.asarray(h),
                              input_factor=jnp.asarray(g),
                              latent=jnp.asarray(lat))
    want = jbl.bitlinear_apply(jnp.asarray(x, jnp.bfloat16), jw)
    tw = tbl.BitLinearWeights(*(None if a is None else torch.from_numpy(
        np.array(a)) for a in jw))
    got = tbl.bitlinear_apply(torch.from_numpy(x).to(torch.bfloat16), tw)
    assert got.dtype == torch.bfloat16
    _close(got, want, tol=2 ** -7)


# ---------------------------------------------------------------------------
# losses and the schedule
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    s, t, hs, ht, ats, att = _rng_arrays(
        4, (2, 9, 50), (2, 9, 50), (3, 2, 9, 16), (3, 2, 9, 16),
        (2, 2, 4, 9, 9), (2, 2, 4, 9, 9))
    labels = np.random.default_rng(5).integers(0, 50, (2, 9))
    labels[0, 3:6] = jlosses.IGNORE_INDEX
    T = torch.from_numpy
    _close(tlosses.kd_kl_loss(T(s), T(t)),
           jlosses.kd_kl_loss(jnp.asarray(s), jnp.asarray(t)))
    _close(tlosses.causal_ce_loss(T(s), T(labels)),
           jlosses.causal_ce_loss(jnp.asarray(s), jnp.asarray(labels)))
    _close(tlosses.hidden_state_loss(T(hs), T(ht), 2),
           jlosses.hidden_state_loss(jnp.asarray(hs), jnp.asarray(ht), 2))
    _close(tlosses.attention_map_loss(T(ats), T(att), 2),
           jlosses.attention_map_loss(jnp.asarray(ats), jnp.asarray(att),
                                      2))
    for kw in ({}, dict(kd_alpha=0.7, kd_beta=1.0, kd_gamma=0.5,
                        kd_loss_scale=0.01)):
        _, got = tlosses.kd_total_loss(
            tlosses.KDConfig(**kw), student_logits=T(s), teacher_logits=T(t),
            labels=T(labels), student_hidden=T(hs), teacher_hidden=T(ht),
            student_attn=T(ats), teacher_attn=T(att), num_layers=2)
        _, want = jlosses.kd_total_loss(
            jlosses.KDConfig(**kw), student_logits=jnp.asarray(s),
            teacher_logits=jnp.asarray(t), labels=jnp.asarray(labels),
            student_hidden=jnp.asarray(hs), teacher_hidden=jnp.asarray(ht),
            student_attn=jnp.asarray(ats), teacher_attn=jnp.asarray(att),
            num_layers=2)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], what=k)
    assert tlosses.IGNORE_INDEX == jlosses.IGNORE_INDEX == -100


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=5, total_steps=40),
    dict(warmup_steps=0, total_steps=12, min_lr_ratio=0.1),
    dict(warmup_steps=4, total_steps=20, lr_schedule="constant")],
    ids=["cosine", "no-warmup-floor", "constant"])
def test_make_schedule_matches_optax(kw):
    want = jt.make_schedule(jt.TrainConfig(**kw))
    got = tt.make_schedule(tt.TrainConfig(**kw))
    for step in range(kw["total_steps"] + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


# ---------------------------------------------------------------------------
# the model: init, packing, the forward's training extras
# ---------------------------------------------------------------------------

def test_init_params_modes_and_pack_model_params():
    c = BitLlamaConfig.named("tiny")
    gen = torch.Generator()
    gen.manual_seed(0)
    for mode, kind in (("latent", "latent"), ("packed", "packed"),
                       ("linear", None)):
        p = tb.init_params(c, gen, mode=mode, device="cpu")
        w = p["layers"]["k_proj"]
        assert p["embed_tokens"].shape == (c.vocab_size, c.hidden_size)
        if kind is None:
            assert w.weight.shape == (2, 128, 256)
        else:
            assert w.mode == kind
    with pytest.raises(ValueError, match="unknown init mode"):
        tb.init_params(c, gen, mode="fp8", device="cpu")
    # the port packs a JAX latent model to the words JAX packs, in the
    # port's layout
    jc = JaxConfig.named("tiny")
    jp = jb.init_params(jc, jax.random.PRNGKey(2))
    jpacked = jb.pack_model_params(jp)
    tp = tb.pack_model_params(params_from_jax(jax.tree.map(np.asarray, jp),
                                              c, device="cpu"))
    for name in jb.PROJ_NAMES:
        words = torch.from_numpy(np.asarray(jpacked["layers"][name].packed))
        assert torch.equal(tp["layers"][name].packed,
                           torch.stack([device_to_kmajor(x) for x in words]))


@pytest.fixture(scope="module")
def kd_models():
    """A linear (FP) teacher of the tiny config, its SVID start student
    (JAX), and both carried over to the port; token blocks."""
    jc = JaxConfig.named("tiny")
    teacher = jb.init_params(jc, jax.random.PRNGKey(1), mode="linear")
    student = jbuild(teacher)
    c = BitLlamaConfig.named("tiny")
    ids = np.random.default_rng(0).integers(0, jc.vocab_size, (4, 64)
                                            ).astype(np.int32)
    return jc, teacher, student, c, ids


def _port(tree, c):
    return params_from_jax(jax.tree.map(np.asarray, tree), c, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_forward_extras_and_remat_gradients(kd_models, remat):
    """Hidden states and attention maps of the student against JAX's, and
    the gradient of a loss of all three outputs with and without remat."""
    jc, _, student, c, ids = kd_models
    want = jb.forward(student, jnp.asarray(ids[:2]), jc,
                      compute_dtype=jnp.float32, output_hidden_states=True,
                      output_attentions=True)
    tp = _port(student, c)
    leaves = tt.trainable_leaves(tp)
    got = tb.forward(tp, torch.from_numpy(ids[:2]).long(), c,
                     compute_dtype=torch.float32, output_hidden_states=True,
                     output_attentions=True, remat=remat)
    assert got[1].shape == (c.num_hidden_layers + 1, 2, 64, c.hidden_size)
    assert got[2].shape == (c.num_hidden_layers, 2, c.num_attention_heads,
                            64, 64)
    for a, w, what in zip(got, want, ("logits", "hidden", "attn")):
        _close(a, w, tol=2e-4, what=what)
    sum(x.float().square().mean() for x in got).backward()
    grads = [p.grad.clone() for p in leaves]
    ref = _port(student, c)
    ref_leaves = tt.trainable_leaves(ref)
    out = tb.forward(ref, torch.from_numpy(ids[:2]).long(), c,
                     compute_dtype=torch.float32, output_hidden_states=True,
                     output_attentions=True)
    sum(x.float().square().mean() for x in out).backward()
    for g, p in zip(grads, ref_leaves):
        assert torch.equal(g, p.grad)


# ---------------------------------------------------------------------------
# KD train steps against JAX's make_train_step
# ---------------------------------------------------------------------------

def _jax_steps(jc, teacher, student, ids, kd, tcfg, n):
    state = jt.init_train_state(jax.tree.map(jnp.copy, student), tcfg)
    step = jt.make_train_step(jc, kd, tcfg, compute_dtype=jnp.float32,
                              donate=False)
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)}
    metrics = []
    for _ in range(n):
        state, m = step(state, teacher, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_steps(c, teacher, student, ids, kd, tcfg, n):
    state = tt.init_train_state(_port(student, c), tcfg)
    step = tt.make_train_step(c, kd, tcfg, compute_dtype=torch.float32)
    teacher = _port(teacher, c)
    metrics = []
    for _ in range(n):
        state, m = step(state, teacher, {"input_ids": ids, "labels": ids})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _leaf_close(got, want, what):
    err = np.linalg.norm(got - want)
    assert err <= TOL * np.linalg.norm(want), (what, err)


@pytest.mark.parametrize("accum", [1, 2])
def test_kd_steps_match_jax(kd_models, accum):
    """Two fp32 KD steps at the reference loss weights (kd_beta 1,
    kd_loss_scale 0.01) with no warmup, so that both move the params: the
    metrics of each step, every updated trainable leaf, and the frozen
    leaves bit-equal to their start."""
    jc, teacher, student, c, ids = kd_models
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10,
              grad_accum_steps=accum)
    jstate, jm = _jax_steps(jc, teacher, student, ids,
                            jlosses.KDConfig(kd_beta=1.0, kd_loss_scale=0.01),
                            jt.TrainConfig(**kw), 2)
    tstate, tm = _port_steps(c, teacher, student, ids,
                             tlosses.KDConfig(kd_beta=1.0,
                                              kd_loss_scale=0.01),
                             tt.TrainConfig(**kw), 2)
    assert tstate.step == 2 and tstate.opt_state.count == 2
    for a, w in zip(tm, jm):
        assert sorted(a) == sorted(w) == ["grad_norm", "kd_loss", "loss",
                                          "pkd_loss", "student_loss"]
        for k in w:
            np.testing.assert_allclose(a[k], w[k], rtol=TOL, err_msg=k)
    got = params_to_numpy(tstate.params)
    want = jax.tree.map(np.asarray, jstate.params)
    start = jax.tree.map(np.asarray, student)
    for name in jb.PROJ_NAMES:
        for field in ("latent", "weight_scale", "input_factor"):
            a = got["layers"][name][field]
            w = getattr(want["layers"][name], field)
            assert not np.array_equal(w, getattr(start["layers"][name],
                                                 field))
            _leaf_close(a, w, f"{name}.{field}")
            if field != "latent":
                _close(a, w, what=f"{name}.{field}")
    for key in ("embed_tokens", "lm_head", "final_norm"):
        assert got[key].tobytes() == start[key].tobytes()
    for key in ("input_layernorm", "post_attention_layernorm"):
        assert got["layers"][key].tobytes() == start["layers"][key].tobytes()


def test_kd_gradients_match_jax(kd_models):
    """The first micro-batch's gradients of every trainable leaf, element
    by element, against ``jax.grad`` of the JAX step's loss."""
    jc, teacher, student, c, ids = kd_models
    kd = dict(kd_beta=1.0, kd_loss_scale=0.01)
    jloss, jteach = jt._build_loss(jc, jlosses.KDConfig(**kd),
                                   jt.TrainConfig(), jnp.float32)
    batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)}
    jgrads, _ = jax.grad(jloss, has_aux=True)(
        student, jt.trainable_mask(student), jteach(teacher, batch), batch)
    tloss, tteach = tt._build_loss(c, tlosses.KDConfig(**kd),
                                   tt.TrainConfig(), torch.float32, "auto")
    tp = _port(student, c)
    tt.trainable_leaves(tp)
    tb_ = {k: torch.from_numpy(ids).long() for k in ("input_ids", "labels")}
    loss, _ = tloss(tp, tteach(_port(teacher, c), tb_), tb_)
    loss.backward()
    for name in jb.PROJ_NAMES:
        for field in ("latent", "weight_scale", "input_factor"):
            _close(getattr(tp["layers"][name], field).grad,
                   getattr(jgrads["layers"][name], field),
                   what=f"{name}.{field}")
    assert tp["embed_tokens"].grad is None and tp["lm_head"].grad is None


def test_kd_attention_map_term_matches_jax(kd_models):
    """kd_gamma > 0 takes the attention maps of both models
    (``output_attentions``, the masked attention in every layer): one step's
    metrics, ``attn_loss`` among them, against JAX's."""
    jc, teacher, student, c, ids = kd_models
    kd = dict(kd_beta=0.0, kd_gamma=0.5, kd_loss_scale=0.01)
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    _, jm = _jax_steps(jc, teacher, student, ids[:2],
                       jlosses.KDConfig(**kd), jt.TrainConfig(**kw), 1)
    _, tm = _port_steps(c, teacher, student, ids[:2], tlosses.KDConfig(**kd),
                        tt.TrainConfig(**kw), 1)
    assert "attn_loss" in tm[0] and sorted(tm[0]) == sorted(jm[0])
    for k in jm[0]:
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=TOL, err_msg=k)


def test_eval_step_and_first_update_under_warmup(kd_models):
    """``make_eval_step`` gives JAX's metrics; under a warmup from 0 the
    first update uses ``schedule(0) = 0`` (optax's count starts at 0), so
    the params do not move; the clip triggers at a small max_grad_norm."""
    jc, teacher, student, c, ids = kd_models
    kd = dict(kd_beta=1.0, kd_loss_scale=0.01)
    jev = jt.make_eval_step(jc, jlosses.KDConfig(**kd), jt.TrainConfig(),
                            compute_dtype=jnp.float32)
    batch = {"input_ids": ids, "labels": ids}
    want = jev(student, teacher, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tev = tt.make_eval_step(c, tlosses.KDConfig(**kd), tt.TrainConfig(),
                            compute_dtype=torch.float32)
    got = tev(_port(student, c), _port(teacher, c), batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL)
    kw = dict(warmup_steps=3, total_steps=10, max_grad_norm=1e-3)
    tstate, tm = _port_steps(c, teacher, student, ids, tlosses.KDConfig(**kd),
                             tt.TrainConfig(**kw), 1)
    start = _port(student, c)
    assert torch.equal(tstate.params["layers"]["q_proj"].latent,
                       start["layers"]["q_proj"].latent)
    assert tm[0]["grad_norm"] > 1e-3
    jstate, _ = _jax_steps(jc, teacher, student, ids,
                           jlosses.KDConfig(**kd), jt.TrainConfig(**kw), 2)
    tstate, _ = _port_steps(c, teacher, student, ids, tlosses.KDConfig(**kd),
                            tt.TrainConfig(**kw), 2)
    _leaf_close(params_to_numpy(tstate.params)["layers"]["v_proj"]["latent"],
                np.asarray(jstate.params["layers"]["v_proj"].latent),
                "v_proj.latent after the clipped second step")
