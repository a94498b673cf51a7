"""Training-path parity: the port's kernels' plain versions, forward, losses,
gradients and train steps against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the JAX
Pallas kernels run in interpret mode on the CPU (``interpret=None``), as
the JAX package's own tests run them.  The port's kernel wrappers run their
plain versions here, because the tensors lie on the CPU (the CUDA kernels
are held to those plain versions on the GPU by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Everything is float32: the two packages
then differ in summation order only, which sets every tolerance below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu.ops.pallas import attention as jat
from deeplearning4j_tpu.ops.pallas import layernorm as jln
from deeplearning4j_tpu.ops.pallas import xent as jxe
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import (params_from_numpy,
                                                     params_to_numpy)
from deeplearning4j_tpu_torch.ops.cuda import attention as tat
from deeplearning4j_tpu_torch.ops.cuda import layernorm as tln
from deeplearning4j_tpu_torch.ops.cuda import registry as treg
from deeplearning4j_tpu_torch.ops.cuda import xent as txe
from deeplearning4j_tpu_torch.utils.tree_math import (tree_leaves,
                                                      tree_unflatten)

CPU = "cpu"
# one f32 kernel or op: summation order only
TOL_OP = 2e-5
# a 2-layer model's loss (relative) and every gradient (max abs error over
# the leaf's max abs value): f32 reassociation through ~20 ops
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype)) \
        .requires_grad_(grad)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: relative max error {err:.3g} > {tol}"


# ------------------------------------------------------------ attention

def _qkv(rng, b=2, t=128, h=2, d=16):
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["flash", "fused"])
def test_attention_forward_and_grads_match_jax(kind, causal, t):
    rng = np.random.default_rng(t + causal)
    q, k, v = _qkv(rng, t=t)
    w = rng.standard_normal(q.shape).astype(np.float32)
    jfn = jfa.flash_attention if kind == "flash" else jat.fused_attention
    tfn = tat.flash_attention if kind == "flash" else tat.fused_attention

    def jloss(q, k, v):
        return jnp.sum(jfn(q, k, v, causal=causal) * w)

    jout = jfn(*map(jnp.asarray, (q, k, v)), causal=causal)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    tout = tfn(tq, tk, tv, causal=causal)
    (tout * _t(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=TOL_OP, rtol=0)
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_OP,
                                   rtol=0, err_msg=f"d{name}")
    assert tat.flash_attention.launches == tat.fused_attention.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_forward_lse_matches_jax_kernel(causal):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, b=1, t=256, h=3, d=8)

    def bhtd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(3, 256, 8)

    jout, jlse = jfa._flash_fwd(bhtd(q), bhtd(k), bhtd(v), causal, 128, 128,
                                True)
    out, lse = tat.reference_flash_fwd(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(lse.reshape(3, 256).numpy(), np.asarray(jlse),
                               atol=TOL_OP, rtol=0)
    np.testing.assert_allclose(out.permute(0, 2, 1, 3).reshape(3, 256, 8)
                               .numpy(), np.asarray(jout), atol=TOL_OP,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_and_ring_attention_match_jax(causal):
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, t=96)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        tat.reference_attention(_t(q), _t(k), _t(v), causal=causal).numpy(),
        np.asarray(jat.reference_attention(jq, jk, jv, causal=causal)),
        atol=TOL_OP, rtol=0)
    np.testing.assert_allclose(
        tat._ring_single_shard(_t(q), _t(k), _t(v), causal=causal).numpy(),
        np.asarray(jat._ring_single_shard(jq, jk, jv, causal=causal)),
        atol=TOL_OP, rtol=0)


# ------------------------------------------------------------ fused LN

@pytest.mark.parametrize("masked", [False, True])
def test_fused_layernorm_forward_and_grads_match_jax(masked):
    rng = np.random.default_rng(7)
    n, d = 37, 48                                  # ragged against 256 rows
    x, r, gy, gh = (rng.standard_normal((n, d)).astype(np.float32)
                    for _ in range(4))
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    mask = ((rng.random((n, 1)) > 0.3) / 0.7).astype(np.float32)
    jm = jnp.asarray(mask) if masked else None

    def jloss(x, r, s, b):
        y, h = jln.fused_residual_layernorm(x, r, s, b, mask=jm)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    jargs = tuple(map(jnp.asarray, (x, r, scale, bias)))
    jy, jh = jln.fused_residual_layernorm(*jargs, mask=jm)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    targs = [_t(a, True) for a in (x, r, scale, bias)]
    ty, th = tln.fused_residual_layernorm(
        *targs, mask=_t(mask) if masked else None)
    ((ty * _t(gy)).sum() + (th * _t(gh)).sum()).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=TOL_OP, rtol=0)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=TOL_OP, rtol=0)
    for name, a, b in zip(("x", "r", "scale", "bias"), targs, jg):
        _close(a.grad.numpy(), b, TOL_OP, f"d{name}")


def test_fused_layernorm_bf16_normalizes_the_unrounded_sum():
    """In bf16, h comes from the f32 y, not the rounded one: the port's
    plain version gives the JAX kernel's bits, and differs from the
    two-op seam, which normalizes the rounded y."""
    rng = np.random.default_rng(8)
    x, r = (rng.standard_normal((64, 32)).astype(np.float32)
            for _ in range(2))
    s, b = np.ones(32, np.float32), np.zeros(32, np.float32)
    jy, jh = jln.fused_residual_layernorm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16),
        jnp.asarray(s), jnp.asarray(b))
    xb, rb = _t(x).bfloat16(), _t(r).bfloat16()
    ty, th = tln.fused_residual_layernorm(xb, rb, _t(s), _t(b))
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh.astype(jnp.float32)))
    _, hu = tln._unfused(xb, rb, _t(s), _t(b))
    assert (hu != th).any()


def test_unfused_layernorm_matches_jax():
    rng = np.random.default_rng(9)
    x, r = (rng.standard_normal((10, 24)).astype(np.float32)
            for _ in range(2))
    s, b = np.full(24, 1.5, np.float32), np.full(24, 0.25, np.float32)
    jy, jh = jln._unfused(*map(jnp.asarray, (x, r, s, b)))
    ty, th = tln._unfused(*map(_t, (x, r, s, b)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL_OP)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL_OP)


# ------------------------------------------------------------ blocked xent

@pytest.mark.parametrize("n,block_t", [(37, 16), (64, 256)])
def test_blocked_xent_forward_and_grads_match_jax(n, block_t):
    rng = np.random.default_rng(n)
    d, v = 24, 101                                 # prime vocabulary
    h = rng.standard_normal((n, d)).astype(np.float32)
    head = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    tg = rng.integers(0, v, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    w[3] = 0.0                                     # a zero-weight row

    def jloss(h, head, w):
        return jxe.blocked_cross_entropy(h, head, jnp.asarray(tg), w,
                                         block_t=block_t)

    jargs = tuple(map(jnp.asarray, (h, head, w)))
    jval = jloss(*jargs)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    th, thead, tw = (_t(a, True) for a in (h, head, w))
    tval = txe.blocked_cross_entropy(th, thead, _t(tg), tw, block_t=block_t)
    tval.backward()
    _close(tval.item(), float(jval), TOL_LOSS, "loss")
    for name, a, b in zip(("h", "head", "w"), (th, thead, tw), jg):
        _close(a.grad.numpy(), b, TOL_OP, f"d{name}")
    assert txe.blocked_cross_entropy.launches == 0


def test_xent_reference_and_scan_match_jax():
    rng = np.random.default_rng(11)
    h = rng.standard_normal((70, 16)).astype(np.float32)
    head = rng.standard_normal((16, 53)).astype(np.float32)
    tg = rng.integers(0, 53, 70).astype(np.int32)
    jargs = (jnp.asarray(h), jnp.asarray(head), jnp.asarray(tg))
    targs = (_t(h), _t(head), _t(tg))
    _close(txe.reference_xent_sum(*targs).item(),
           float(jxe.reference_xent_sum(*jargs)), TOL_LOSS, "reference")
    _close(txe._scan_xent_sum(*targs, block_t=32).item(),
           float(jxe._scan_xent_sum(*jargs, block_t=32)), TOL_LOSS, "scan")
    wloss, lse = txe.reference_xent_rows(*targs)
    jw, jl = jxe._xent_fwd(jnp.asarray(np.pad(h, ((0, 2), (0, 0)))),
                           jargs[1], jnp.asarray(np.pad(tg, (0, 2))),
                           jnp.ones((72,), jnp.float32), 8, 16, True)
    np.testing.assert_allclose(wloss.numpy(), np.asarray(jw)[:70],
                               atol=TOL_OP * 10, rtol=TOL_OP)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:70],
                               atol=TOL_OP * 10, rtol=TOL_OP)


# ------------------------------------------------------------ registry

def test_registry_has_the_training_kinds_with_torch_incumbents():
    from deeplearning4j_tpu.ops.pallas import registry as jreg
    for kind, inc in (("attention", "ring"), ("layernorm_residual",
                                              "unfused"), ("xent", "scan")):
        names = {c.name for c in treg.candidates(kind)}
        assert names == {c.name for c in jreg.candidates(kind)}, kind
        assert treg.get(kind, inc).source == "torch"
        assert all(c.source == "cuda" for c in treg.candidates(kind)
                   if c.name != inc)
        for c in treg.candidates(kind):
            assert c.tolerances == jreg.get(kind, c.name).tolerances


# ------------------------------------------------------------ model

def _cfgs(**kw):
    base = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_len=128)
    base.update(kw)
    return (jtr.TransformerConfig(dtype=jnp.float32, **base),
            ttr.TransformerConfig(dtype=torch.float32, **base))


def _params(jcfg, seed=0):
    jp = jtr.init_params(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)


def _data(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _loss_and_grads(jcfg, tcfg, b, t):
    jp, tp = _params(jcfg)
    toks, tg = _data(jcfg, b, t)
    jl, jg = jax.value_and_grad(jtr.lm_loss_local)(
        jp, jnp.asarray(toks), jnp.asarray(tg), jcfg)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    tl = ttr.lm_loss_local(tp, _t(toks), _t(tg), tcfg)
    tg_ = torch.autograd.grad(tl, leaves)
    return (float(jl), jax.tree_util.tree_leaves(jg)), (tl.item(), tg_)


LOSS_CASES = {
    "ring-causal-scan": (dict(), 2, 128),
    "flash-bidir-fusedln-blocked": (dict(attention="flash", causal=False,
                                         fused_ln=True, xent_impl="blocked"),
                                    2, 128),
    "fused-causal-fusedln-blocked": (dict(attention="fused", fused_ln=True,
                                          xent_impl="blocked"), 2, 128),
    "flash-causal-gqa2": (dict(attention="flash", n_kv_heads=2), 2, 128),
    "fused-bidir-mqa-fusedln": (dict(attention="fused", causal=False,
                                     n_kv_heads=1, fused_ln=True), 1, 128),
    "ring-bidir-gqa2-chunked": (dict(causal=False, n_kv_heads=2,
                                     xent_chunk=64), 2, 128),
    "near-prime-127": (dict(xent_chunk=64), 1, 127),
    "untied-full-logits": (dict(tie_embeddings=False, xent_chunk=0,
                                attention="flash", fused_ln=True), 1, 128),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_and_all_grads_match_jax(case):
    kw, b, t = LOSS_CASES[case]
    jcfg, tcfg = _cfgs(remat=False, **kw)
    (jl, jg), (tl, tg) = _loss_and_grads(jcfg, tcfg, b, t)
    _close(tl, jl, TOL_LOSS, "loss")
    assert len(jg) == len(tg)
    for i, (a, want) in enumerate(zip(tg, jg)):
        _close(a.numpy(), want, TOL_GRAD, f"grad leaf {i}")


def test_kernel_routing_counts_and_near_prime_route():
    """attention kernels take T % 128 == 0 only (the reference's rule, not
    a fallback); 127 near-prime tokens take the blocked xent route."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    kern = ttr.TrainKernels(
        attention=spy("attn", tat.flash_attention),
        residual_layernorm=spy("ln", tln.fused_residual_layernorm),
        xent=spy("xent", txe.blocked_cross_entropy))
    _, tcfg = _cfgs(attention="flash", fused_ln=True, xent_chunk=64)
    tp = ttr.init_params(torch.Generator().manual_seed(0), tcfg, CPU)
    for t, want in ((128, ["attn", "ln"] * 2), (127, ["ln"] * 2 + ["xent"])):
        calls.clear()
        toks, tg = _data(tcfg, 1, t)
        ttr.lm_loss_local(tp, _t(toks), _t(tg), tcfg, kernels=kern)
        assert calls == want, (t, calls)


def test_remat_gives_the_same_grads():
    _, c_remat = _cfgs(attention="fused", fused_ln=True, xent_impl="blocked",
                       remat=True)
    _, c_plain = _cfgs(attention="fused", fused_ln=True, xent_impl="blocked",
                       remat=False)
    tp = ttr.init_params(torch.Generator().manual_seed(1), c_plain, CPU)
    toks, tg = _data(c_plain, 2, 128, seed=2)
    out = []
    for cfg in (c_remat, c_plain):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(tp)]
        live = tree_unflatten(tp, leaves)
        loss = ttr.lm_loss_local(live, _t(toks), _t(tg), cfg)
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_forward_and_score_match_jax():
    jcfg, tcfg = _cfgs(attention="flash", fused_ln=True)
    jp, tp = _params(jcfg)
    toks, tg = _data(jcfg, 2, 128)
    jl = jtr.TransformerLM(jcfg).forward(jp, jnp.asarray(toks))
    model = ttr.TransformerLM(tcfg, device=CPU)
    _close(model.forward(tp, toks).numpy(), jl, TOL_GRAD, "logits")
    _close(model.score(tp, toks, tg),
           jtr.TransformerLM(jcfg).score(jp, toks, tg), TOL_LOSS, "score")


def test_sequence_and_tensor_axes_raise():
    """The sp and tp axes run over a mesh of ranks (their runs against the
    JAX package are in test_torch_model_parallel.py): outside an active
    mesh ring attention over sp and a block over tp raise, and a mesh
    with an sp or tp axis wider than 1 needs an initialized process
    group."""
    _, tcfg = _cfgs()
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="no active mesh"):
        ttr.ring_attention(x, x, x, n_sp=2, sp_axis="sp", causal=True,
                           t_local=4)
    tp = ttr.init_params(torch.Generator().manual_seed(0), tcfg, CPU)
    with pytest.raises(RuntimeError, match="no active mesh"):
        ttr._block(tp["layers"][0], torch.zeros((1, 4, 32)), tcfg,
                   tp_axis="tp")
    from deeplearning4j_tpu_torch.parallel.mesh import (MeshSpec as TSpec,
                                                        RankDevice,
                                                        make_mesh as tmake)

    for spec in (TSpec(dp=1, sp=2), TSpec(dp=1, tp=2)):
        with pytest.raises(RuntimeError, match="process group"):
            ttr.TransformerLM(tcfg, device=CPU, mesh=tmake(
                spec, devices=[RankDevice(0), RankDevice(1)]))


# ------------------------------------------------------------ train steps

def _trajectory(jcfg, tcfg, jtx, ttx, steps=5, b=2, t=128):
    jp, tp = _params(jcfg, seed=3)
    jm, tm = jtr.TransformerLM(jcfg), ttr.TransformerLM(tcfg, device=CPU)
    jopt, topt = jm.init_opt(jp, jtx), tm.init_opt(tp, ttx)
    jstep, tstep = jm.build_train_step(jtx), tm.build_train_step(ttx)
    jl, tl = [], []
    for s in range(steps):
        toks, tg = _data(jcfg, b, t, seed=10 + s)
        jp, jopt, loss = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(tg))
        jl.append(float(loss))
        tp, topt, loss = tstep(tp, topt, _t(toks), _t(tg))
        tl.append(loss.item())
    return jl, tl, jp, tp, topt


@pytest.mark.parametrize("kind", ["adamw-warmup-cosine", "momentum-sgd"])
def test_train_step_trajectory_matches_jax(kind):
    from deeplearning4j_tpu.optimize import transforms as JT
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    jcfg, tcfg = _cfgs(attention="flash", fused_ln=True, xent_impl="blocked",
                       causal=False, remat=False)
    if kind == "momentum-sgd":
        jtx, ttx = None, None                  # the default transform
    else:
        jtx = JT.adamw(JT.warmup_cosine(1e-2, 2, 10), weight_decay=0.01)
        ttx = TT.adamw(TT.warmup_cosine(1e-2, 2, 10), weight_decay=0.01)
    jl, tl, jp, tp, topt = _trajectory(jcfg, tcfg, jtx, ttx)
    assert topt[0] == 5
    assert jl[-1] < jl[0]                      # the run trains
    # five optimizer steps compound the f32 reassociation of each gradient
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for a, b in zip(tree_leaves(params_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)


def test_decay_mask_hook_steers_weight_decay():
    """A model whose ``_decay_mask`` names no leaf takes adamw steps that
    equal adam's; the default mask decays the ndim >= 2 leaves."""
    from deeplearning4j_tpu_torch.optimize import transforms as TT

    from deeplearning4j_tpu_torch.utils.tree_math import tree_map

    class NoDecay(ttr.TransformerLM):
        def _decay_mask(self, tree):
            return tree_map(lambda _: False, tree)

    _, tcfg = _cfgs(remat=False)
    toks, tg = _data(tcfg, 2, 16)
    out = {}
    for name, cls, tx in (("adam", ttr.TransformerLM, TT.adam(1e-2)),
                          ("adamw-nodecay", NoDecay, TT.adamw(1e-2, 0.5)),
                          ("adamw", ttr.TransformerLM, TT.adamw(1e-2, 0.5))):
        model = cls(tcfg, device=CPU)
        tp = model.init(torch.Generator().manual_seed(5))
        new, _, _ = model.build_train_step(tx)(tp, model.init_opt(tp, tx),
                                               _t(toks), _t(tg))
        out[name] = tree_leaves(new)
    assert all(torch.equal(a, b) for a, b in zip(out["adam"],
                                                 out["adamw-nodecay"]))
    assert not torch.equal(out["adam"][-1], out["adamw"][-1])  # tok_embed


def test_fit_runs_the_same_steps_and_keeps_the_count(tmp_path):
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import CheckpointManager
    _, tcfg = _cfgs(remat=False)
    model = ttr.TransformerLM(tcfg, device=CPU)
    tx = TT.adam(1e-3)
    tp = model.init(torch.Generator().manual_seed(4))
    batches = [_data(tcfg, 2, 16, seed=s) for s in range(3)]
    p1, o1, l1 = model.fit(tp, model.init_opt(tp, tx), batches, tx=tx,
                           epochs=2)
    step = model.build_train_step(tx)
    p2, o2, l2 = tp, model.init_opt(tp, tx), []
    for k in range(6):
        p2, o2, loss = step(p2, o2, *map(_t, batches[k % 3]))
        l2.append(loss.item())
    assert o1[0] == o2[0] == 6 and l1 == l2
    # a carried-over state continues where it left off: nothing to do
    assert model.fit(p1, o1, batches, tx=tx, epochs=2)[2] == []
    # with a checkpoint manager: the same steps, saved every 4 and at the
    # end; a fresh fit resumes from the newest save with nothing left to do
    mgr = CheckpointManager(tmp_path, keep=5)
    p3, o3, l3 = model.fit(tp, model.init_opt(tp, tx), batches, tx=tx,
                           epochs=2, checkpoint_manager=mgr,
                           checkpoint_every=4)
    assert l3 == l1 and mgr.all_steps() == [4, 6]
    p4, o4, l4 = model.fit(tp, model.init_opt(tp, tx), batches, tx=tx,
                           epochs=2, checkpoint_manager=mgr)
    assert l4 == [] and o4[0] == 6
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p4),
                                                  tree_leaves(p1)))


def test_finetune_step_matches_jax():
    from deeplearning4j_tpu.optimize import transforms as JT
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    jcfg, tcfg = _cfgs(causal=False, attention="flash", remat=False)
    jm, tm = jtr.TransformerLM(jcfg), ttr.TransformerLM(tcfg, device=CPU)
    jtree = jm.init_finetune(jax.random.key(0), 3)
    ttree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), CPU)
    assert set(ttree) == {"backbone", "head"}
    toks, _ = _data(jcfg, 4, 128)
    labels = np.array([0, 2, 1, 2], np.int32)
    jtx, ttx = JT.adam(1e-3), TT.adam(1e-3)
    jtree2, _, jl = jm.build_finetune_step(jtx)(
        jtree, jm.init_opt(jtree, jtx), jnp.asarray(toks), jnp.asarray(labels))
    ttree2, topt, tl = tm.build_finetune_step(ttx)(
        ttree, tm.init_opt(ttree, ttx), _t(toks), _t(labels))
    _close(tl.item(), float(jl), TOL_LOSS, "loss")
    back = params_to_numpy(ttree2)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(jtree2)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    # the head the port draws itself has the JAX package's shapes
    own = tm.init_finetune(torch.Generator().manual_seed(0), 3)
    assert {k: tuple(v.shape) for k, v in own["head"].items()} == \
        {k: tuple(v.shape) for k, v in jtree["head"].items()}
