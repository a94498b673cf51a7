"""Kernel-module parity between the JAX package and its PyTorch port.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX kernels run as the JAX package's own tests run them on the CPU:
``interpret=None`` selects Pallas interpret mode off-TPU.  The port's
wrappers run their plain versions here, because the tensors lie on the
CPU (the CUDA kernels are held to the same plain versions on the GPU by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas import kv_quant as jkvq
from deeplearning4j_tpu.ops.pallas import matmul_int8 as jmm
from deeplearning4j_tpu.ops.pallas import paged_attention as jpa
from deeplearning4j_tpu.ops.pallas import registry as jreg
from deeplearning4j_tpu_torch.ops.cuda import kv_quant as tkvq
from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa
from deeplearning4j_tpu_torch.ops.cuda import registry as treg

# f32 on both sides: the two only differ in summation order
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ------------------------------------------------------------ int8 matmul

@pytest.mark.parametrize("shape", [(64, 96), (48, 97), (33, 1)])
def test_quantize_bitwise_equal_to_jax(shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0                     # an all-zero column takes scale 1/127
    w[1, -1] = 0.5 * np.abs(w[:, -1]).max()   # exact .5 multiples round even
    jq = jmm.quantize(jnp.asarray(w))
    tq = tmm.quantize(_t(w))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tmm.dequantize(tq).numpy(),
                                  np.asarray(jmm.dequantize(jq)))


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("n", [128, 97])
def test_int8_matmul_plain_matches_jax_kernel_and_reference(m, n):
    rng = np.random.default_rng(m * 1000 + n)
    k = 64
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq = jmm.quantize(jnp.asarray(w))
    tq = tmm.quantize(_t(w))
    out = tmm.int8_matmul(_t(x), tq).numpy()
    assert out.dtype == np.float32 and out.shape == (m, n)
    np.testing.assert_allclose(
        out, np.asarray(jmm.int8_matmul(jnp.asarray(x), jq)), atol=TOL,
        rtol=0)
    np.testing.assert_allclose(
        out, np.asarray(jmm.reference_int8_matmul(jnp.asarray(x), jq)),
        atol=TOL, rtol=0)
    assert tmm.int8_matmul.launches == 0   # CPU tensors launch nothing


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_matmul_input_grad_matches_jax_grad(lead):
    """dx through the port's autograd.Function against jax.grad of the JAX
    kernel (its custom_vjp, interpret mode); the int8 leaves get none."""
    import jax

    rng = np.random.default_rng(11)
    k, n = 48, 97
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal(lead + (k,)).astype(np.float32)
    c = rng.standard_normal(lead + (n,)).astype(np.float32)
    jq = jmm.quantize(jnp.asarray(w))
    jdx = jax.grad(lambda xx: jnp.sum(jmm.int8_matmul(xx, jq) * c))(
        jnp.asarray(x))
    tq = tmm.quantize(_t(w))
    xt = _t(x).requires_grad_(True)
    (tmm.int8_matmul(xt, tq) * _t(c)).sum().backward()
    assert xt.grad.dtype == torch.float32 and xt.grad.shape == x.shape
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=TOL,
                               rtol=0)
    assert tq.q.grad is None and tq.scale.grad is None


def test_int8_matmul_keeps_leading_dims_and_top1():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 40)).astype(np.float32)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    tq = tmm.quantize(_t(w))
    out = tmm.int8_matmul(_t(x), tq)
    assert out.shape == (2, 3, 40)
    ref = _t(x).reshape(-1, 32) @ _t(w)
    assert tmm.top1_agreement(out.reshape(-1, 40), ref) >= 0.8


def test_quantize_params_for_decode_matches_jax_tree():
    rng = np.random.default_rng(1)
    layer = {"w1": rng.standard_normal((8, 16)).astype(np.float32),
             "w2": rng.standard_normal((16, 8)).astype(np.float32),
             "b1": np.zeros(16, np.float32)}
    tree = {"tok_embed": rng.standard_normal((11, 8)).astype(np.float32),
            "layers": [layer]}

    class Cfg:
        tie_embeddings = True

    jt = jmm.quantize_params_for_decode(
        {"tok_embed": jnp.asarray(tree["tok_embed"]),
         "layers": [{k: jnp.asarray(v) for k, v in layer.items()}]}, Cfg)
    tt = tmm.quantize_params_for_decode(
        {"tok_embed": _t(tree["tok_embed"]),
         "layers": [{k: _t(v) for k, v in layer.items()}]}, Cfg)
    assert set(tt["layers"][0]) == set(jt["layers"][0])
    for key in ("w1_q", "w2_q"):
        np.testing.assert_array_equal(tt["layers"][0][key].q.numpy(),
                                      np.asarray(jt["layers"][0][key].q))
    np.testing.assert_array_equal(tt["head_q"].scale.numpy(),
                                  np.asarray(jt["head_q"].scale))


# ------------------------------------------------------------ kv quant

def _pool(rng, P=6, ps=4, K=2, Dh=8, scale=1.0):
    return (scale * rng.standard_normal((P, ps, K, Dh))).astype(np.float32)


def test_kv_quant_requantize_dequantize_neutral_bitwise():
    rng = np.random.default_rng(7)
    f = _pool(rng)
    f[2] = 0.0                                  # a wiped page
    s0 = np.full((6, 2), jkvq.neutral_scale(jnp.int8), np.float32)
    s0[1] = 0.5                                 # a monotone scale to keep
    assert tkvq.neutral_scale(torch.int8) == jkvq.neutral_scale(jnp.int8)
    jq, js = jkvq.requantize_pool(jnp.asarray(f), jnp.asarray(s0), jnp.int8)
    tq, ts = tkvq.requantize_pool(_t(f), _t(s0), torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jd = np.asarray(jkvq.dequantize_pool(jq, js, dt_j).astype(jnp.float32))
        td = tkvq.dequantize_pool(tq, ts, dt_t).float().numpy()
        np.testing.assert_array_equal(td, jd)
    # an unchanged pool requantizes to byte-identical storage
    tq2, ts2 = tkvq.requantize_pool(tkvq.dequantize_pool(tq, ts), ts,
                                    torch.int8)
    np.testing.assert_array_equal(tq2.numpy(), tq.numpy())
    np.testing.assert_array_equal(ts2.numpy(), ts.numpy())


def test_kv_quant_modes_and_itemsize():
    assert tkvq.KV_QUANT_MODES == jkvq.KV_QUANT_MODES == ("int8", "fp8")
    assert tkvq.storage_dtype("int8") == torch.int8
    # fp8 pages, as the reference's: e4m3, qmax 448, one byte
    assert tkvq.storage_dtype("fp8") == torch.float8_e4m3fn
    assert jkvq.storage_dtype("fp8") == jnp.float8_e4m3fn
    fp8 = torch.float8_e4m3fn
    assert tkvq.qmax(fp8) == jkvq.qmax(jnp.float8_e4m3fn) == 448.0
    assert tkvq.neutral_scale(fp8) == jkvq.neutral_scale(jnp.float8_e4m3fn)
    assert tkvq.kv_itemsize("fp8", torch.bfloat16) == 1
    with pytest.raises(ValueError):
        tkvq.storage_dtype("int4")
    assert tkvq.kv_itemsize("int8", torch.bfloat16) == 1
    assert tkvq.kv_itemsize(None, torch.bfloat16) == 2
    assert tkvq.kv_itemsize(None, torch.float32) == 4


# ------------------------------------------------------------ paged attention

def _paged_case(seed, H, Kv, lengths, ps=4, n_pages=4, Dh=8):
    """A pool with a trash page (the last one) and block tables: each row
    owns ceil(len/ps) pages, the tail of its row parks on the trash
    page; a row whose length is 0 in ``lengths`` is an inactive slot:
    length 1 (pos 0 + 1) over an all-trash row."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    P = B * n_pages + 1
    trash = P - 1
    k = _pool(rng, P, ps, Kv, Dh)
    v = _pool(rng, P, ps, Kv, Dh)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    perm = list(rng.permutation(P - 1))
    bt = np.full((B, n_pages), trash, np.int32)
    lens = np.zeros(B, np.int32)
    for b, L in enumerate(lengths):
        if L == 0:
            lens[b] = 1               # inactive: frozen pos 0, trash row
            continue
        need = -(-L // ps)
        bt[b, :need] = [perm.pop() for _ in range(need)]
        lens[b] = L
    return q, k, v, bt, lens


CASES = [
    # (H, Kv, lengths): MHA, GQA, MQA; length 1; partial last page;
    # a full table; an inactive (trash-page) row
    (4, 4, [1, 6, 16, 0]),
    (4, 2, [3, 9, 0, 13]),
    (4, 1, [16, 1, 5, 0]),
    # ragged extremes: rows of 1 beside full-table rows and a trash row
    (4, 2, [1, 16, 0, 16, 1]),
]


@pytest.mark.parametrize("H,Kv,lengths", CASES)
def test_paged_attention_plain_matches_jax(H, Kv, lengths):
    q, k, v, bt, lens = _paged_case(H * 10 + Kv, H, Kv, lengths)
    out = tpa.paged_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, bt, lens))
    np.testing.assert_allclose(out, np.asarray(jpa.paged_attention(*args)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        out, np.asarray(jpa.reference_paged_attention(*args)),
        atol=TOL, rtol=0)
    assert np.isfinite(out).all()


def _u8(t: torch.Tensor) -> np.ndarray:
    """The bytes of a torch tensor (fp8 has no numpy dtype of its own)."""
    return t.contiguous().view(torch.uint8).numpy()


def _jfp8(t: torch.Tensor):
    """A torch float8_e4m3fn tensor as a jnp float8_e4m3fn array."""
    return jnp.asarray(_u8(t).view(jnp.float8_e4m3fn))


def test_kv_quant_fp8_cast_bitwise():
    """``cast_to`` fp8: the clamp to ±448 and the round-to-nearest-even
    cast, byte for byte the reference's, over edge values (the finite
    max, values past it, subnormals, signed zeros) and random ones."""
    rng = np.random.default_rng(11)
    edge = np.array([448, -448, 464, -464, 500, -500, 1e6, -1e6, 0.0, -0.0,
                     2 ** -9, -2 ** -9, 2 ** -10, 3 * 2 ** -10, 2 ** -6,
                     0.1, 1.0625, 1.1875, 240, 232, 480, 447.9],
                    np.float32)
    x = np.concatenate([edge, (rng.standard_normal(4096) * 100)
                        .astype(np.float32),
                        (rng.standard_normal(4096) * 0.01)
                        .astype(np.float32)])
    got = _u8(tkvq.cast_to(_t(x), torch.float8_e4m3fn))
    want = np.asarray(jkvq.cast_to(jnp.asarray(x), jnp.float8_e4m3fn)) \
        .view(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert not torch.isnan(tkvq.cast_to(_t(x), torch.float8_e4m3fn)
                           .float()).any()


def test_kv_quant_fp8_requantize_dequantize_bitwise():
    """fp8 pools: requantize and dequantize bitwise the reference's (the
    storage compared through its bytes), monotone scales kept, and an
    unchanged pool requantizes to the same bytes."""
    rng = np.random.default_rng(12)
    f = _pool(rng, scale=3.0)
    f[2] = 0.0                                  # a wiped page
    fp8, jfp8 = torch.float8_e4m3fn, jnp.float8_e4m3fn
    s0 = np.full((6, 2), jkvq.neutral_scale(jfp8), np.float32)
    s0[1] = 0.5                                 # a monotone scale to keep
    jq, js = jkvq.requantize_pool(jnp.asarray(f), jnp.asarray(s0), jfp8)
    tq, ts = tkvq.requantize_pool(_t(f), _t(s0), fp8)
    assert tq.dtype == fp8
    np.testing.assert_array_equal(_u8(tq), np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jd = np.asarray(jkvq.dequantize_pool(jq, js, dt_j).astype(jnp.float32))
        td = tkvq.dequantize_pool(tq, ts, dt_t).float().numpy()
        np.testing.assert_array_equal(td, jd)
    tq2, ts2 = tkvq.requantize_pool(tkvq.dequantize_pool(tq, ts), ts, fp8)
    np.testing.assert_array_equal(_u8(tq2), _u8(tq))
    np.testing.assert_array_equal(ts2.numpy(), ts.numpy())


@pytest.mark.parametrize("H,Kv,lengths", CASES)
def test_paged_attention_fp8_plain_matches_jax(H, Kv, lengths):
    """#7's plain version over e4m3 pages against the reference kernel in
    interpret mode and its plain version: within TOL (the same values,
    the same f32 arithmetic; the registry's band is 0.05)."""
    q, k, v, bt, lens = _paged_case(H * 10 + Kv + 2, H, Kv, lengths)
    fp8 = torch.float8_e4m3fn
    s0 = np.full((k.shape[0], Kv), tkvq.neutral_scale(fp8), np.float32)
    kq, ks = tkvq.requantize_pool(_t(k), _t(s0), fp8)
    vq, vs = tkvq.requantize_pool(_t(v), _t(s0), fp8)
    out = tpa.paged_attention_int8(_t(q), kq, vq, ks, vs, _t(bt),
                                   _t(lens)).numpy()
    args = (jnp.asarray(q), _jfp8(kq), _jfp8(vq), jnp.asarray(ks.numpy()),
            jnp.asarray(vs.numpy()), jnp.asarray(bt), jnp.asarray(lens))
    np.testing.assert_allclose(
        out, np.asarray(jpa.paged_attention_int8(*args, interpret=True)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        out, np.asarray(jpa.reference_paged_attention_int8(*args)),
        atol=TOL, rtol=0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("H,Kv,lengths", CASES)
def test_paged_attention_int8_plain_matches_jax(H, Kv, lengths):
    q, k, v, bt, lens = _paged_case(H * 10 + Kv + 1, H, Kv, lengths)
    s0 = np.full((k.shape[0], Kv), 1 / 127, np.float32)
    kq, ks = tkvq.requantize_pool(_t(k), _t(s0), torch.int8)
    vq, vs = tkvq.requantize_pool(_t(v), _t(s0), torch.int8)
    out = tpa.paged_attention_int8(_t(q), kq, vq, ks, vs, _t(bt),
                                   _t(lens)).numpy()
    args = (jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
            jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
            jnp.asarray(bt), jnp.asarray(lens))
    np.testing.assert_allclose(
        out, np.asarray(jpa.paged_attention_int8(*args)), atol=TOL, rtol=0)
    np.testing.assert_allclose(
        out, np.asarray(jpa.reference_paged_attention_int8(*args)),
        atol=TOL, rtol=0)


def test_paged_attention_ignores_content_past_length():
    """Masked positions (partial last page, trash page) contribute
    exactly 0: scribbling on them leaves the result bitwise unchanged."""
    q, k, v, bt, lens = _paged_case(5, 4, 2, [6, 3])
    base = tpa.paged_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens))
    k2, v2 = k.copy(), v.copy()
    k2[bt[0, 1], 2:] = 1e4           # row 0: positions 6, 7 of its page 1
    v2[bt[0, 1], 2:] = -1e4
    k2[-1] = 1e4                     # the trash page
    out = tpa.paged_attention(_t(q), _t(k2), _t(v2), _t(bt), _t(lens))
    torch.testing.assert_close(out, base, rtol=0, atol=0)


# ------------------------------------------------------------ registry

def _rows(kind, cand, cand_tps, check, inc, inc_tps):
    rows = [{"kernel": kind, "candidate": cand, "tokens_per_sec": t}
            for t in cand_tps]
    if check is not None:
        rows.append({"kernel": kind, "candidate": cand, "check": check})
    rows += [{"kernel": kind, "candidate": inc, "tokens_per_sec": t}
             for t in inc_tps]
    return rows


# the JAX package's kernel names and the port's, per registry kind
NAMES = {
    "int8_matmul": (("pallas_int8", "cuda_int8"), "f32"),
    "paged_attention": (("pallas", "cuda"), "gather"),
    "paged_attention_int8": (("pallas_int8", "cuda_int8"), "gather_int8"),
}

SCENARIOS = [
    ([200.0], {"max_err": 1e-4, "top1_agree": 1.0}, [100.0]),   # adopt
    ([101.0], {"max_err": 1e-4, "top1_agree": 1.0}, [100.0]),   # margin
    ([200.0], {"max_err": 0.5, "top1_agree": 1.0}, [100.0]),    # max_err
    ([200.0], {"max_err": 1e-4, "top1_agree": 0.99}, [100.0]),  # min floor
    ([200.0], None, [100.0]),                                   # no check
    ([200.0], {"max_err": 1e-4, "top1_agree": 1.0}, []),        # no incumbent
    ([0.0], {"max_err": 1e-4, "top1_agree": 1.0}, [100.0]),     # broken row
    ([200.0], {}, [100.0]),                                     # empty check
]


@pytest.mark.parametrize("kind", sorted(NAMES))
@pytest.mark.parametrize("scenario", range(len(SCENARIOS)))
def test_registry_verdicts_match_jax(kind, scenario):
    (jname, tname), inc = NAMES[kind]
    cand_tps, check, inc_tps = SCENARIOS[scenario]
    jrows = _rows(kind, jname, cand_tps, check, inc, inc_tps)
    trows = _rows(kind, tname, cand_tps, check, inc, inc_tps)
    jpick = jreg.autopick(kind, jrows, incumbent=inc)
    tpick = treg.autopick(kind, trows, incumbent=inc)
    assert (tpick.choice == inc) == (jpick.choice == inc)
    assert len(tpick.dropped) == len(jpick.dropped)
    assert [d["reason"] for d in tpick.dropped] == [
        d["reason"].replace(jname, tname) for d in jpick.dropped]
    if check:
        assert (treg.check_passes(treg.get(kind, tname), check)
                == jreg.check_passes(jreg.get(kind, jname), check))


def test_registry_surface():
    # every kernel kind of the JAX package, now that all seven are ported
    assert treg.kinds() == jreg.kinds() == [
        "attention", "int8_matmul", "layernorm_residual", "paged_attention",
        "paged_attention_int8", "xent"]
    for kind, ((_, tname), inc) in NAMES.items():
        cand, incumbent = treg.get(kind, tname), treg.get(kind, inc)
        assert cand.source == "cuda" and incumbent.source == "torch"
        assert cand.reference is incumbent.fn
        assert cand.tolerances == jreg.get(kind, NAMES[kind][0][0]).tolerances
    with pytest.raises(KeyError, match="registered"):
        treg.get("paged_attention", "pallas")
    with pytest.raises(ValueError):
        treg.register(treg.KernelCandidate(
            kind="paged_attention", name="cuda", fn=lambda *a: None))


def test_registry_records_a_failed_kernel_import(monkeypatch):
    """A kernel module that fails to import is recorded in
    ``import_errors()``, and the other candidates still load (the
    reference's ``_ensure_loaded``); a healthy install records none."""
    assert treg.import_errors() == jreg.import_errors() == {}
    bad = "deeplearning4j_tpu_torch.ops.cuda.no_such_kernel"
    monkeypatch.setattr(treg, "_KERNEL_MODULES",
                        (bad,) + treg._KERNEL_MODULES)
    monkeypatch.setattr(treg, "_IMPORT_ERRORS", {})
    monkeypatch.setattr(treg, "_LOADED", False)
    assert treg.kinds() == jreg.kinds()
    errors = treg.import_errors()
    assert list(errors) == [bad] and "no_such_kernel" in errors[bad]


def test_engine_raises_when_its_kernel_candidate_is_absent(monkeypatch):
    """An engine whose ``paged_attention_impl`` names a candidate that did
    not load raises, naming the import errors; it never serves through
    the plain version in the kernel's place."""
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ServingConfig)

    cfg = ttr.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, max_len=16)
    model = ttr.TransformerLM(cfg, device="cpu")
    registry = {k: v for k, v in treg._REGISTRY.items()
                if k != ("paged_attention_int8", "cuda_int8")}
    monkeypatch.setattr(treg, "_REGISTRY", registry)
    monkeypatch.setattr(treg, "_IMPORT_ERRORS", {
        "deeplearning4j_tpu_torch.ops.cuda.paged_attention": "OSError()"})
    for impl in ("cuda_int8", "pallas_int8"):
        with pytest.raises(RuntimeError, match="failed to import.*OSError"):
            InferenceEngine(model, model.init(), cfg=ServingConfig(
                paged=True, kv_quant="fp8", paged_attention_impl=impl),
                device="cpu")
