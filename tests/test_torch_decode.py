"""Decode-path parity: the port's transformer against the JAX package.

Parameters come from the JAX package's ``init_params`` and cross over
through numpy (``params_from_numpy``).  Everything runs in float32 on the
CPU, where the two packages differ only in summation order: logits are
held within 1e-4 and greedy tokens must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.ops.pallas import kv_quant as jkvq
from deeplearning4j_tpu.ops.pallas import matmul_int8 as jmm
from deeplearning4j_tpu.ops.pallas import paged_attention as jpa
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import (params_from_numpy,
                                                     params_to_numpy)
from deeplearning4j_tpu_torch.ops.cuda import kv_quant as tkvq
from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa

TOL = 1e-4
CPU = "cpu"


def _cfgs(n_kv_heads=None, vocab=97, d_model=32, max_len=32):
    kw = dict(vocab_size=vocab, d_model=d_model, n_heads=4, n_layers=2,
              d_ff=64, max_len=max_len, n_kv_heads=n_kv_heads)
    return (jtr.TransformerConfig(dtype=jnp.float32, **kw),
            ttr.TransformerConfig(dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = jtr.init_params(jax.random.key(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("n_kv_heads", [None, 2, 1])
def test_params_convert_round_trip(n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads)
    jp, tp = _params(jcfg)
    assert set(tp["layers"][0]) == set(jp["layers"][0])
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_b)
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port's own init gives the same tree shape
    own = ttr.init_params(torch.Generator().manual_seed(0), tcfg, CPU)
    for key, leaf in own["layers"][0].items():
        assert tuple(leaf.shape) == tuple(jp["layers"][0][key].shape), key


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_decode_step_logits_match_jax(int8, n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads)
    jp, tp = _params(jcfg, seed=1)
    if int8:
        jp = jmm.quantize_params_for_decode(jp, jcfg)
        tp = tmm.quantize_params_for_decode(tp, tcfg)
    B = 3
    jc = jtr.init_decode_cache(jcfg, B)
    tc = ttr.init_decode_cache(tcfg, B, CPU)
    jstep = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    rng = np.random.default_rng(2)
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(5):
        tok = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = ttr.decode_step(tp, tc, torch.from_numpy(tok),
                                 torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=0)
        pos = pos + 1
    np.testing.assert_allclose(tc[1]["k"].numpy(), _np(jc[1]["k"]),
                               atol=TOL, rtol=0)


def _paged_setup(jcfg, tcfg, quant, B=3, ps=4):
    n_slot = -(-jcfg.max_len // ps)
    P = B * n_slot + 1
    trash = P - 1
    if quant:
        jpages = jkvq.init_quantized_paged_cache(jcfg, P, ps, "int8")
        tpages = tkvq.init_quantized_paged_cache(tcfg, P, ps, "int8", CPU)
    else:
        jpages = jtr.init_paged_cache(jcfg, P, ps)
        tpages = ttr.init_paged_cache(tcfg, P, ps, CPU)
    rng = np.random.default_rng(3)
    perm = list(rng.permutation(P - 1))
    bt = np.full((B, n_slot), trash, np.int32)
    for b in range(B - 1):               # the last row stays inactive
        bt[b, :4] = [perm.pop() for _ in range(4)]
    return jpages, tpages, bt


@pytest.mark.parametrize("quant,kernel,n_kv_heads", [
    (False, False, None), (False, True, 1), (True, False, 1),
    (True, True, None)])
def test_decode_step_paged_logits_match_jax(quant, kernel, n_kv_heads):
    """float and int8 pools, int8 weights, the gather path and the
    kernel hook (JAX's interpret-mode Pallas kernel vs the port's wrapper,
    which runs its plain version on the CPU)."""
    jcfg, tcfg = _cfgs(n_kv_heads)
    jp, tp = _params(jcfg, seed=4)
    jp = jmm.quantize_params_for_decode(jp, jcfg)
    tp = tmm.quantize_params_for_decode(tp, tcfg)
    jpages, tpages, bt = _paged_setup(jcfg, tcfg, quant)
    jfn = tfn = None
    if kernel:
        jfn = jpa.paged_attention_int8 if quant else jpa.paged_attention
        tfn = tpa.paged_attention_int8 if quant else tpa.paged_attention
    jstep = jax.jit(functools.partial(jtr.decode_step_paged, cfg=jcfg,
                                      attn_fn=jfn))
    rng = np.random.default_rng(5)
    pos = np.array([0, 5, 0], np.int32)
    for _ in range(5):
        tok = rng.integers(0, jcfg.vocab_size, 3).astype(np.int32)
        jl, jpages = jstep(jp, jpages, jnp.asarray(bt), jnp.asarray(tok),
                           jnp.asarray(pos))
        tl, tpages = ttr.decode_step_paged(
            tp, tpages, torch.from_numpy(bt), torch.from_numpy(tok),
            torch.from_numpy(pos), tcfg, attn_fn=tfn)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL, rtol=0)
        pos[:2] += 1                      # the inactive row stays frozen
    if quant:
        # quantize-at-write: storage and scales of the real pages agree
        real = bt[:2].reshape(-1)
        np.testing.assert_allclose(tpages[0]["k_scale"].numpy()[real],
                                   _np(jpages[0]["k_scale"])[real],
                                   rtol=1e-5, atol=0)


def test_paged_helpers_match_jax():
    jcfg, tcfg = _cfgs(2)
    jpages, tpages, bt = _paged_setup(jcfg, tcfg, quant=True)
    rng = np.random.default_rng(6)
    flat = np.array([1, 9, 17], np.int64)
    k = rng.standard_normal((3, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 2, 8)).astype(np.float32)
    j2 = jtr.scatter_paged_layer(jpages[0], jnp.asarray(flat),
                                 jnp.asarray(k), jnp.asarray(v))
    t2 = ttr.scatter_paged_layer(tpages[0], torch.from_numpy(flat),
                                 torch.from_numpy(k), torch.from_numpy(v))
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(t2[key].numpy(), _np(j2[key]))
    jk, jv = jtr.gather_paged_layer(j2, jnp.asarray(bt), 32, jnp.float32)
    tk, tv = ttr.gather_paged_layer(t2, torch.from_numpy(bt), 32,
                                    torch.float32)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    mask = np.zeros(tpages[0]["k"].shape[0], bool)
    mask[[1, 4]] = True
    jr = jtr.reset_cache_pages([j2], jnp.asarray(mask))[0]
    tr = ttr.reset_cache_pages([t2], torch.from_numpy(mask))[0]
    for key in ("k", "k_scale"):
        np.testing.assert_array_equal(tr[key].numpy(), _np(jr[key]))
    pos = np.array([[0, 5, 31]] * 3, np.int32)
    np.testing.assert_array_equal(
        ttr.paged_flat_index(torch.from_numpy(bt), torch.from_numpy(pos),
                             4).numpy(),
        _np(jtr.paged_flat_index(jnp.asarray(bt), jnp.asarray(pos), 4)))


@pytest.mark.parametrize("positions", [
    [[-1, -5, 0, 15, 16, 40]],            # before the table, in it, past it
    [[-16, -13, -9, 3, 4, 63]]])          # down to a whole table back
def test_paged_flat_index_out_of_range_positions_equal_jax(positions):
    """A position outside ``[0, n_pages * page_size)`` indexes the block
    table as the reference's ``take_along_axis`` does (negative pages
    from the end, pages past it clamped to the last): never an
    out-of-range ``torch.gather``, which on CUDA is a device-side
    assert.  (More than a table back the reference reads its fill value
    through int32 overflow; the port clamps to page 0.)"""
    bt = np.array([[3, 5, 7, 9]], np.int32)
    pos = np.array(positions, np.int32)
    got = ttr.paged_flat_index(torch.from_numpy(bt), torch.from_numpy(pos), 4)
    want = _np(jtr.paged_flat_index(jnp.asarray(bt), jnp.asarray(pos), 4))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64
    far = ttr.paged_flat_index(torch.from_numpy(bt), torch.tensor([[-100]]), 4)
    assert far.item() == 3 * 4 + 0                 # page 0, in the table


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_greedy_sample_tokens_identical_to_jax(n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads)
    jp, tp = _params(jcfg, seed=7)
    prime = [5, 17, 3, 60]
    jt = jtr.TransformerLM(jcfg).sample(jp, prime, 12, temperature=0.0,
                                        kv_cache=True)
    tt = ttr.TransformerLM(tcfg, device=CPU).sample(tp, prime, 12,
                                                    temperature=0.0)
    assert tt == jt
    assert len(tt) == len(prime) + 12 and tt[:4] == prime


def test_sampled_decode_follows_its_generator():
    """Sampled decoding is the port's own torch.Generator stream: the same
    seed gives the same tokens, another seed (almost surely) not, and the
    full-forward default and the KV-cached path draw the same stream."""
    _, tcfg = _cfgs()
    lm = ttr.TransformerLM(tcfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(3))
    a = lm.sample(params, [1, 2, 3], 16, temperature=1.0, seed=11)
    b = lm.sample(params, [1, 2, 3], 16, temperature=1.0, seed=11)
    c = lm.sample(params, [1, 2, 3], 16, temperature=1.0, seed=12)
    assert a == b and a != c
    assert lm.sample(params, [1, 2, 3], 16, temperature=1.0, seed=11,
                     kv_cache=True) == a
