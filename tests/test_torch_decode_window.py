"""The rest of decoding against the JAX package: the out-of-range drop of
``scatter_paged_layer``, the speculative verify windows, the full-forward
``sample`` and ``beam_search``.

A small model (2 layers, d_model 64, 4 heads, vocab 97) in float32 on the
CPU; parameters and inputs come from numpy seeds and cross over through
numpy.  Logits are held within 1e-5 and tokens must be identical; a drop
must leave the rest of the pool byte-identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.ops.pallas import matmul_int8 as jmm
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.ops.cuda import kv_quant as tkvq
from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa
from torch_sync_guard import NoHostSync

TOL = 1e-5
CPU = "cpu"
KW = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_len=32)


def _cfgs(**kw):
    kw = dict(KW, **kw)
    return (jtr.TransformerConfig(dtype=jnp.float32, **kw),
            ttr.TransformerConfig(dtype=torch.float32, **kw))


def _params(jcfg, seed=0, int8=False):
    jp = jtr.init_params(jax.random.key(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    if int8:
        jp = jmm.quantize_params_for_decode(jp, jcfg)
        tp = tmm.quantize_params_for_decode(tp, ttr.TransformerConfig(
            dtype=torch.float32, **KW))
    return jp, tp


def _torch_np(tree):
    return [{k: v.numpy().copy() for k, v in layer.items()} for layer in tree]


def _pools(jcfg, tcfg, quant, P, ps, seed):
    """The same random pool content in both packages (an int8 pool is
    quantized once from random floats)."""
    rng = np.random.default_rng(seed)
    jl, tl = [], []
    for _ in range(jcfg.n_layers):
        shape = (P, ps, jcfg.kv_heads, jcfg.head_dim)
        kf = rng.standard_normal(shape).astype(np.float32)
        vf = rng.standard_normal(shape).astype(np.float32)
        if quant:
            s0 = np.full((P, jcfg.kv_heads), 1 / 127, np.float32)
            layer = {}
            for key, f in (("k", kf), ("v", vf)):
                q, s = tkvq.requantize_pool(torch.from_numpy(f),
                                            torch.from_numpy(s0), torch.int8)
                layer[key], layer[key + "_scale"] = q.numpy(), s.numpy()
        else:
            layer = {"k": kf, "v": vf}
        jl.append({k: jnp.asarray(v) for k, v in layer.items()})
        tl.append({k: torch.from_numpy(v.copy()) for k, v in layer.items()})
    return jl, tl


# ------------------------------------------------------------ the drop

@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ["mixed", "first_out", "all_out"])
def test_scatter_paged_layer_drops_out_of_range(quant, case):
    """Out-of-range entries of ``flat`` are not written, on float and int8
    pools: the pool equals one scattered with the in-range entries alone,
    byte for byte, and the JAX package's ``mode="drop"`` scatter."""
    jcfg, tcfg = _cfgs()
    P, ps = 9, 4
    n = P * ps
    flat = {"mixed": [3, n, 17, n + 5, 30],
            "first_out": [n, 2, n * 3, 21],
            "all_out": [n, n + 1, 4 * n]}[case]
    flat = np.asarray(flat, np.int64)
    rng = np.random.default_rng(1)
    kv = [rng.standard_normal((len(flat), 4, 16)).astype(np.float32)
          for _ in range(2)]
    jl, tl = _pools(jcfg, tcfg, quant, P, ps, seed=2)
    _, t_in = _pools(jcfg, tcfg, quant, P, ps, seed=2)
    before = _torch_np(tl)
    keep = flat < n
    out = ttr.scatter_paged_layer(tl[0], torch.from_numpy(flat),
                                  *map(torch.from_numpy, kv))
    ref = ttr.scatter_paged_layer(t_in[0], torch.from_numpy(flat[keep]),
                                  *(torch.from_numpy(a[keep]) for a in kv))
    j2 = jtr.scatter_paged_layer(jl[0], jnp.asarray(flat),
                                 *map(jnp.asarray, kv))
    for key in out:
        np.testing.assert_array_equal(out[key].numpy(), ref[key].numpy())
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(j2[key]))
    if case == "all_out":
        for key in out:
            np.testing.assert_array_equal(out[key].numpy(), before[0][key])


def test_scatter_paged_fp8_keeps_untouched_pages_byte_identical():
    """The write into an fp8 pool (dequantize the pool, scatter,
    requantize against monotone scales) leaves every page it does not
    touch byte-identical, and writes the bytes the JAX package writes;
    through the dropping scatter and through the paged step's own."""
    jcfg, _ = _cfgs()
    P, ps, K, Dh = 9, 4, jcfg.kv_heads, jcfg.head_dim
    rng = np.random.default_rng(4)
    fp8 = torch.float8_e4m3fn
    s0 = torch.full((P, K), tkvq.neutral_scale(fp8))
    layer = {}
    for key in ("k", "v"):
        f = torch.from_numpy(rng.standard_normal((P, ps, K, Dh))
                             .astype(np.float32))
        layer[key], layer[key + "_scale"] = tkvq.requantize_pool(f, s0, fp8)
    flat = np.asarray([5, 6, 29], np.int64)         # pages 1 and 7
    kv = [rng.standard_normal((3, K, Dh)).astype(np.float32) * 3
          for _ in range(2)]

    def u8(t):
        return t.contiguous().view(torch.uint8).numpy().copy()

    before = {key: u8(t) for key, t in layer.items()}
    jlayer = {key: jnp.asarray(before[key].view(jnp.float8_e4m3fn))
              if key in ("k", "v") else jnp.asarray(t.numpy())
              for key, t in layer.items()}
    want = jtr.scatter_paged_layer(jlayer, jnp.asarray(flat),
                                   *map(jnp.asarray, kv))
    touched = np.zeros(P, bool)
    touched[flat // ps] = True
    for put in (ttr.scatter_rows, ttr._put_rows):
        c = {key: t.clone() for key, t in layer.items()}
        ttr._scatter_paged(c, torch.from_numpy(flat),
                           *map(torch.from_numpy, kv), put)
        for key in ("k", "v"):
            got = u8(c[key])
            assert c[key].dtype == fp8
            np.testing.assert_array_equal(
                got, np.asarray(want[key]).view(np.uint8))
            np.testing.assert_array_equal(got[~touched],
                                          before[key][~touched])
            assert (got[touched] != before[key][touched]).any()
            np.testing.assert_array_equal(c[key + "_scale"].numpy(),
                                          np.asarray(want[key + "_scale"]))


def test_scatter_rows_drop_needs_no_host_sync(monkeypatch):
    """The drop stays on the device: no ``nonzero``, ``item`` (also the
    one ATen makes of a 0-d tensor index) or copy to the host (the
    engine's hot-loop rule)."""
    dst = torch.zeros((6, 3))
    idx = torch.tensor([7, 1, 6, 4])
    val = torch.arange(12.0).reshape(4, 3)

    def boom(*a, **k):
        raise AssertionError("host sync in scatter_rows")

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "numpy", "nonzero"):
            m.setattr(torch.Tensor, name, boom)
        with NoHostSync():
            ttr.scatter_rows(dst, idx, val)
    want = torch.zeros((6, 3))
    want[1], want[4] = val[1], val[3]
    assert torch.equal(dst, want)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_paths_make_no_host_sync(quant, monkeypatch):
    """Every decode path the engine's hot loop runs, with positions on
    the device as the engine keeps them: the paged step through the
    paged-attention wrapper, the paged and the dense verify window (a
    window running past ``max_len``) and the dense step, over an int8
    serving tree; none reads a value to the host."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, seed=5, int8=True)
    B, W, T, ps = 2, 4, jcfg.max_len, 4
    n_slot = T // ps
    P = B * n_slot + 1
    _, pages = _pools(jcfg, tcfg, quant, P, ps, seed=7)
    bt = torch.arange(B * n_slot, dtype=torch.int32).reshape(B, n_slot)
    cache = ttr.init_decode_cache(tcfg, B, CPU)
    attn = tpa.paged_attention_int8 if quant else tpa.paged_attention
    tok = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.tensor([5, T - 2], dtype=torch.int32)
    win = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)

    def boom(*a, **k):
        raise AssertionError("host sync in a decode path")

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "numpy", "nonzero"):
            m.setattr(torch.Tensor, name, boom)
        with NoHostSync() as guard:
            out = [ttr.decode_step_paged(tp, pages, bt, tok, pos, tcfg,
                                         attn_fn=attn)[0],
                   ttr.decode_window_paged(tp, pages, bt, win, pos,
                                           tcfg)[0],
                   ttr.decode_step(tp, cache, tok, pos, tcfg)[0],
                   ttr.decode_window(tp, cache, win, pos, tcfg)[0]]
    assert guard.seen > 0
    assert [tuple(o.shape) for o in out] == [(B, 97), (B, W, 97)] * 2
    assert all(torch.isfinite(o).all() for o in out)


# ------------------------------------------------------------ windows

def _warm(step, state, B, start, vocab):
    for i in range(start):
        tok = np.full((B,), (i * 7) % vocab, np.int32)
        state = step(state, tok, np.full((B,), i, np.int32))
    return state


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("start", [6, KW["max_len"] - 2])
def test_decode_window_matches_steps_and_jax(start, int8):
    """Dense window: logits equal W sequential port ``decode_step`` calls
    and the JAX ``decode_window``; the cache equals the sequential one,
    where a window position past ``max_len`` wrote nothing."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=3, int8=int8)
    B, W, T = 2, 4, jcfg.max_len
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             (B, W)).astype(np.int32)
    pos = np.full((B,), start, np.int32)

    def tstep(cache, tok, p):
        ttr.decode_step(tp, cache, torch.from_numpy(tok),
                        torch.from_numpy(p), tcfg)
        return cache

    jstep = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))

    def jwarm(cache, tok, p):
        return jstep(jp, cache, jnp.asarray(tok), jnp.asarray(p))[1]

    tc_win = _warm(tstep, ttr.init_decode_cache(tcfg, B, CPU), B, start,
                   jcfg.vocab_size)
    tc_seq = [{k: v.clone() for k, v in c.items()} for c in tc_win]
    jc = _warm(jwarm, jtr.init_decode_cache(jcfg, B), B, start,
               jcfg.vocab_size)
    tl, _ = ttr.decode_window(tp, tc_win, torch.from_numpy(toks),
                              torch.from_numpy(pos), tcfg)
    jl, jc = jtr.decode_window(jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                               jcfg)
    for w in range(W):
        if start + w >= T:
            continue
        sl, _ = ttr.decode_step(tp, tc_seq, torch.from_numpy(toks[:, w]),
                                torch.from_numpy(pos + w), tcfg)
        np.testing.assert_allclose(tl[:, w].numpy(), sl.numpy(), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(tl[:, w].numpy(), np.asarray(jl[:, w]),
                                   atol=TOL, rtol=0)
    for a, b, j in zip(tc_win, tc_seq, jc):
        for key in ("k", "v"):
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                       atol=TOL, rtol=0)
            np.testing.assert_allclose(a[key].numpy(), np.asarray(j[key]),
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("quant,int8", [(False, False), (False, True),
                                        (True, True)])
@pytest.mark.parametrize("start", [5, KW["max_len"] - 2])
def test_decode_window_paged_matches_steps_and_jax(start, quant, int8):
    """Paged window over float and int8 pools: logits equal the JAX
    ``decode_window_paged`` and, on float pools, W sequential port
    ``decode_step_paged`` calls (an int8 page written a position at a time
    requantizes between the writes, so there the window and the steps
    round differently by design, in both packages); pages the windows
    must not touch (free ones, the trash page) keep their bytes, even
    where a window runs past ``max_len``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=5, int8=int8)
    B, W, T, ps = 2, 4, jcfg.max_len, 4
    n_slot = T // ps
    P = 3 * n_slot + 1
    rng = np.random.default_rng(6)
    perm = rng.permutation(P - 1)
    bt = perm[:B * n_slot].reshape(B, n_slot).astype(np.int32)
    untouched = sorted(set(range(P)) - set(bt.reshape(-1).tolist()))
    jl0, tl0 = _pools(jcfg, tcfg, quant, P, ps, seed=7)
    _, t_seq = _pools(jcfg, tcfg, quant, P, ps, seed=7)
    before = _torch_np(tl0)
    toks = rng.integers(0, jcfg.vocab_size, (B, W)).astype(np.int32)
    pos = np.array([start, start - 3], np.int32)
    tl, _ = ttr.decode_window_paged(tp, tl0, torch.from_numpy(bt),
                                    torch.from_numpy(toks),
                                    torch.from_numpy(pos), tcfg)
    jl, jpages = jtr.decode_window_paged(jp, jl0, jnp.asarray(bt),
                                         jnp.asarray(toks), jnp.asarray(pos),
                                         jcfg)
    for w in range(W):
        live = pos + w < T
        sl, _ = ttr.decode_step_paged(
            tp, t_seq, torch.from_numpy(bt), torch.from_numpy(toks[:, w]),
            torch.from_numpy(np.minimum(pos + w, T - 1)), tcfg)
        if not quant:
            np.testing.assert_allclose(tl[:, w].numpy()[live],
                                       sl.numpy()[live], atol=TOL, rtol=0)
        np.testing.assert_allclose(tl[:, w].numpy()[live],
                                   np.asarray(jl[:, w])[live], atol=TOL,
                                   rtol=0)
    for layer, ref, jlay in zip(tl0, before, jpages):
        for key in layer:
            np.testing.assert_array_equal(layer[key].numpy()[untouched],
                                          ref[key][untouched])
            np.testing.assert_allclose(layer[key].numpy().astype(np.float32),
                                       np.asarray(jlay[key]).astype(
                                           np.float32), atol=TOL, rtol=0)


# ------------------------------------------------------------ sample, beam

@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_sample_full_forward_matches_kv_cache_and_jax(n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads=n_kv_heads)
    jp, tp = _params(jcfg, seed=8)
    prime = [5, 17, 3, 60, 2]
    lm = ttr.TransformerLM(tcfg, device=CPU)
    full = lm.sample(tp, prime, 10, temperature=0.0)
    assert full == lm.sample(tp, prime, 10, temperature=0.0, kv_cache=True)
    assert full == jtr.TransformerLM(jcfg).sample(jp, prime, 10,
                                                  temperature=0.0)
    for seed, temp in ((3, 1.0), (11, 0.7)):
        a = lm.sample(tp, prime, 10, temperature=temp, seed=seed)
        assert a == lm.sample(tp, prime, 10, temperature=temp, seed=seed,
                              kv_cache=True)


@pytest.mark.parametrize("width,length", [(4, 8), (3, 5), (1, 6)])
def test_beam_search_matches_jax(width, length):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=9)
    prime = [7, 1, 30]
    jseq, jscore = jtr.TransformerLM(jcfg).beam_search(jp, prime, length,
                                                       beam_width=width)
    tseq, tscore = ttr.TransformerLM(tcfg, device=CPU).beam_search(
        tp, prime, length, beam_width=width)
    assert tseq == jseq
    assert len(tseq) == len(prime) + length and tseq[:3] == prime
    assert abs(tscore - jscore) <= 1e-4


def test_beam_search_takes_an_int8_serving_tree():
    """``beam_search`` over ``quantize_params_for_decode``'s tree runs the
    int8 FFN/head (M = beam width) and matches the JAX package's."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=10, int8=True)
    jseq, jscore = jtr.TransformerLM(jcfg).beam_search(jp, [4, 9], 6,
                                                       beam_width=4)
    tseq, tscore = ttr.TransformerLM(tcfg, device=CPU).beam_search(
        tp, [4, 9], 6, beam_width=4)
    assert tseq == jseq and abs(tscore - jscore) <= 1e-4
