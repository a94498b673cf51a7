"""The port's DL4J tensor substrate against the JAX package's: losses,
activations, convolution and pooling, sampling, linalg, dtypes and rng.

Inputs come from numpy with a seed and go through both packages in
float32.  Forward values and gradients are held to 1e-5 relative (the two
differ in summation order only).  ``blocked_mcxent``'s ``(h, head)`` form
runs the JAX package's Pallas kernel as its own CPU tests run it and the
port's plain version, on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as JA
from deeplearning4j_tpu.ops import convolution as JC
from deeplearning4j_tpu.ops import dtypes as JD
from deeplearning4j_tpu.ops import linalg as JL
from deeplearning4j_tpu.ops import losses as JLo
from deeplearning4j_tpu_torch.ops import activations as TA
from deeplearning4j_tpu_torch.ops import convolution as TC
from deeplearning4j_tpu_torch.ops import dtypes as TD
from deeplearning4j_tpu_torch.ops import linalg as TL
from deeplearning4j_tpu_torch.ops import losses as TLo
from deeplearning4j_tpu_torch.ops import rng as TR
from deeplearning4j_tpu_torch.ops import sampling as TS
from deeplearning4j_tpu_torch.ops.cuda import xent as txe

TOL = 1e-5


def _close(t, j, tol=TOL):
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


def _inputs(seed, n=6, c=5):
    rng = np.random.default_rng(seed)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    logits = rng.standard_normal((n, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return labels, logits, probs.astype(np.float32)


# ------------------------------------------------------------------ losses

_PROB_LOSSES = [l.value for l in JLo.LossFunction
                if l != JLo.LossFunction.BLOCKED_MCXENT]


def test_every_loss_function_is_ported():
    assert [l.value for l in TLo.LossFunction] == \
        [l.value for l in JLo.LossFunction]
    assert len(TLo.LossFunction) == 12


@pytest.mark.parametrize("name", _PROB_LOSSES)
def test_loss_value_and_grad_match_jax(name):
    labels, _, probs = _inputs(1)
    jv, jg = jax.value_and_grad(
        lambda o: JLo.score(name, jnp.asarray(labels), o))(jnp.asarray(probs))
    out = torch.from_numpy(probs.copy()).requires_grad_()
    tv = TLo.score(name, torch.from_numpy(labels), out)
    (tg,) = torch.autograd.grad(tv, out)
    _close(tv, jv)
    _close(tg, jg)


def test_blocked_mcxent_on_logits_matches_jax():
    labels, logits, _ = _inputs(2, n=9, c=7)
    jv, jg = jax.value_and_grad(lambda o: JLo.score(
        "blocked_mcxent", jnp.asarray(labels), o))(jnp.asarray(logits))
    out = torch.from_numpy(logits.copy()).requires_grad_()
    tv = TLo.score("blocked_mcxent", torch.from_numpy(labels), out)
    (tg,) = torch.autograd.grad(tv, out)
    _close(tv, jv)
    _close(tg, jg)


@pytest.mark.parametrize("n,d,v", [(16, 12, 10), (37, 250, 10)])
def test_blocked_mcxent_on_hiddens_and_head_matches_jax(n, d, v):
    """The ``(h, head)`` form: the JAX package's blocked kernel against
    the port's plain version (the wrapper's CPU path), value and the
    gradients of h and head."""
    rng = np.random.default_rng(n)
    h = rng.standard_normal((n, d)).astype(np.float32)
    head = (0.2 * rng.standard_normal((d, v))).astype(np.float32)
    labels = np.eye(v, dtype=np.float32)[rng.integers(0, v, n)]
    jv, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: JLo.score("blocked_mcxent", jnp.asarray(labels), (a, b)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h.copy()).requires_grad_()
    tw = torch.from_numpy(head.copy()).requires_grad_()
    before = txe.blocked_cross_entropy.launches
    tv = TLo.score("blocked_mcxent", torch.from_numpy(labels), (th, tw))
    assert txe.blocked_cross_entropy.launches == before   # CPU: plain
    tgh, tgw = torch.autograd.grad(tv, (th, tw))
    _close(tv, jv)
    _close(tgh, jgh)
    _close(tgw, jgw)


def test_xent_pad_d_keeps_the_logits_exact():
    """The bf16 kernel's D padding: zero columns of h, zero rows of the
    head, so every logit is the same sum plus exact zeros."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn((5, 250), generator=g).to(torch.bfloat16)
    head = torch.randn((250, 10), generator=g).to(torch.bfloat16)
    hp, headp = txe._pad_d(h, head)
    assert hp.shape == (5, 256) and headp.shape == (256, 10)
    assert hp.dtype == headp.dtype == torch.bfloat16
    assert torch.equal(hp[:, :250], h) and not hp[:, 250:].any()
    assert torch.equal(headp[:250], head) and not headp[250:].any()
    exact = h.double() @ head.double()
    assert torch.equal(hp.double() @ headp.double(), exact)
    t = torch.randint(0, 10, (5,), generator=g, dtype=torch.int32)
    w = torch.ones(5)
    a = txe.reference_xent_rows(hp, headp, t, w)
    b = txe.reference_xent_rows(h, head, t, w)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ activations

@pytest.mark.parametrize("name", JA.names())
def test_activation_and_derivative_match_jax(name):
    assert TA.names() == JA.names()
    x = np.random.default_rng(3).standard_normal((4, 6)).astype(np.float32)
    x[0, :3] = (-1.0, 0.5, 2.0)
    _close(TA.apply(name, torch.from_numpy(x)), JA.apply(name, jnp.asarray(x)))
    if name == "logsoftmax":
        for mod, arr in ((TA, torch.from_numpy(x)), (JA, jnp.asarray(x))):
            with pytest.raises(ValueError, match="row-wise"):
                mod.apply_derivative(name, arr)
        return
    _close(TA.apply_derivative(name, torch.from_numpy(x)),
           JA.apply_derivative(name, jnp.asarray(x)))


def test_softmax_and_unknown_activation():
    x = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    _close(TA.softmax(torch.from_numpy(x)), JA.softmax(jnp.asarray(x)))
    with pytest.raises(ValueError, match="unknown activation"):
        TA.get("nope")


# ------------------------------------------------------------------ convolution

@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [(3, 3), (2, 2), (4, 3)])
def test_conv2d_matches_jax(padding, stride, kernel):
    rng = np.random.default_rng(sum(kernel) + stride)
    x = rng.standard_normal((2, 3, 9, 8)).astype(np.float32)
    w = rng.standard_normal((4, 3) + kernel).astype(np.float32)
    j = JC.conv2d(jnp.asarray(x), jnp.asarray(w), (stride, stride), padding,
                  precision=jax.lax.Precision.HIGHEST)
    t = TC.conv2d(torch.from_numpy(x), torch.from_numpy(w), (stride, stride),
                  padding)
    assert tuple(t.shape) == j.shape
    _close(t, j)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("window,stride", [((2, 2), None), ((3, 3), (2, 2)),
                                           ((3, 2), (1, 1))])
def test_pools_match_jax(padding, window, stride):
    x = np.random.default_rng(5).standard_normal((2, 3, 7, 8)).astype(
        np.float32)
    for jf, tf in ((JC.max_pool, TC.max_pool), (JC.avg_pool, TC.avg_pool)):
        j = jf(jnp.asarray(x), window, stride, padding)
        t = tf(torch.from_numpy(x), window, stride, padding)
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("kh,kw,stride", [(3, 3, 1), (2, 2, 2), (3, 2, 2)])
def test_im2col_matches_jax(padding, kh, kw, stride):
    x = np.random.default_rng(6).standard_normal((2, 3, 7, 6)).astype(
        np.float32)
    j = JC.im2col(jnp.asarray(x), kh, kw, (stride, stride), padding)
    t = TC.im2col(torch.from_numpy(x), kh, kw, (stride, stride), padding)
    assert tuple(t.shape) == j.shape
    _close(t, j)


def test_same_pads_put_the_odd_pixel_high():
    assert TC.same_pads(7, 2, 2) == (0, 1)
    assert TC.same_pads(8, 3, 1) == (1, 1)
    assert TC.same_pads(8, 4, 1) == (1, 2)
    with pytest.raises(ValueError, match="padding"):
        TC.conv2d(torch.zeros(1, 1, 3, 3), torch.zeros(1, 1, 2, 2),
                  padding="FULL")


# ------------------------------------------------------------------ sampling

def test_sampling_arithmetic_on_jax_draws():
    """``jax.random.bernoulli(key, p)`` is ``uniform(key) < p`` and the
    port's Bernoulli is the same comparison on its draws."""
    key = jax.random.key(7)
    p = jnp.asarray(np.random.default_rng(7).uniform(size=(5, 6)),
                    jnp.float32)
    j = jax.random.bernoulli(key, p).astype(jnp.float32)
    u = jax.random.uniform(key, p.shape, jnp.float32)
    t = TS._bernoulli(torch.tensor(np.asarray(u)), torch.tensor(np.asarray(p)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_samplers_draw_from_the_generator():
    g = TR.key_for(3, device="cpu")
    p = torch.full((2000,), 0.3)
    b = TS.binomial(g, p)
    assert set(b.unique().tolist()) <= {0.0, 1.0}
    assert abs(b.mean().item() - 0.3) < 0.05
    b3 = TS.binomial(g, p, n=3)
    assert b3.max().item() <= 3 and abs(b3.mean().item() - 0.9) < 0.1
    m = TS.dropout_mask(g, (4000,), 0.25)
    assert set(m.unique().tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}
    assert abs(m.mean().item() - 1.0) < 0.05
    assert torch.equal(TS.dropout_mask(g, (3,), 0.0), torch.ones(3))
    assert torch.equal(TS.dropout_mask(g, (3,), 1.0), torch.zeros(3))
    u = TS.uniform(g, (1000,), -2.0, 3.0)
    assert u.min() >= -2.0 and u.max() < 3.0
    n = TS.normal(g, (4000,), 1.0, 2.0)
    assert abs(n.mean().item() - 1.0) < 0.15 and abs(n.std().item() - 2) < 0.15
    gs = TS.gaussian(g, torch.zeros(4000), 0.5)
    assert abs(gs.std().item() - 0.5) < 0.05
    # one seed, one stream
    a = TS.binomial(TR.key_for(11, device="cpu"), p)
    assert torch.equal(a, TS.binomial(TR.key_for(11, device="cpu"), p))


def test_rng_stream_splits_without_reading_the_device():
    s = TR.RngStream(5, device="cpu")
    k1, k2 = s.split(2)
    assert k1.initial_seed() != k2.initial_seed()
    t = TR.RngStream(5, device="cpu")
    assert [k.initial_seed() for k in t.split(2)] == \
        [k1.initial_seed(), k2.initial_seed()]
    assert s.uniform((3,), 1.0, 2.0).min() >= 1.0
    assert s.normal((2, 2)).shape == (2, 2)
    assert sorted(s.permutation(6).tolist()) == list(range(6))
    assert TR.key_for(None, device="cpu").initial_seed() == 123
    g = torch.Generator().manual_seed(9)
    assert TR.RngStream(g).gen is g


# ------------------------------------------------------------------ linalg, dtypes

def test_linalg_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((5, 3)).astype(np.float32)
    x = rng.standard_normal(7).astype(np.float32)
    y = rng.standard_normal(7).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(TL.gemm(T(a), T(b)), JL.gemm(J(a), J(b),
                                        precision=jax.lax.Precision.HIGHEST))
    _close(TL.dot(T(x), T(y)), JL.dot(J(x), J(y)))
    _close(TL.axpy(0.5, T(x), T(y)), JL.axpy(0.5, J(x), J(y)))
    assert int(TL.iamax(T(a))) == int(JL.iamax(J(a)))
    _close(TL.nrm2(T(x)), JL.nrm2(J(x)))
    _close(TL.to_flattened([T(a), T(b)]), JL.to_flattened([J(a), J(b)]))


def test_gemm_under_bf16_compute_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((16, 4)).astype(np.float32)
    try:
        TD.bf16_compute()
        JD.bf16_compute()
        t = TL.gemm(torch.from_numpy(a), torch.from_numpy(b))
        j = JL.gemm(jnp.asarray(a), jnp.asarray(b),
                    precision=jax.lax.Precision.HIGHEST)
    finally:
        TD.set_policy(torch.float32, torch.float32)
        JD.set_policy(jnp.float32, jnp.float32)
    assert t.dtype == torch.float32
    _close(t, j)


def test_dtype_policy():
    pol = TD.set_policy(compute_dtype="bfloat16")
    try:
        assert pol.compute_dtype == torch.bfloat16
        assert pol.param_dtype == torch.float32
        assert TD.get_policy() is pol
        assert pol.cast_compute(torch.ones(2)).dtype == torch.bfloat16
        assert pol.cast_param(torch.ones(2, dtype=torch.bfloat16)).dtype \
            == torch.float32
        assert pol.cast_compute(3) == 3
    finally:
        TD.set_policy(torch.float32, torch.float32)
    assert TD.get_policy() == TD.DtypePolicy()
