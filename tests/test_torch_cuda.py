"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: these need an NVIDIA GPU with ``nvcc`` and skip
elsewhere (the CPU tests hold the plain versions to the JAX package).
On a machine with the card: ``python -m pytest tests/test_torch_cuda.py
-q -m cuda --noconftest`` (the repo conftest imports jax).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.cuda import kv_quant
from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 768, 3072), (8, 3072, 768),
                                   (5, 64, 97), (20, 128, 1003),
                                   (3, 1024, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(m + n)
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    qw = tmm.quantize(w)
    before = tmm.int8_matmul.launches
    out = tmm.int8_matmul(x, qw)
    torch.cuda.synchronize()
    assert tmm.int8_matmul.launches == before + 1
    ref = tmm.reference_int8_matmul(x, qw)
    # f32 out either way; the two differ by summation order only
    assert (out - ref).abs().max().item() < 1e-4


@pytest.mark.parametrize("m", [1, 3, 8, 9, 16, 17, 40])
@pytest.mark.parametrize("k", [1, 100, 4097])
@pytest.mark.parametrize("n", [1, 15, 17, 3000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_int8_matmul_kernel_ragged_shapes(dev, m, k, n, dtype):
    """Ragged N edges, N not a multiple of the 16- or 8-byte load (byte
    loads), K of one row, of a split that is not a multiple of the row
    groups, and larger than one cluster of x tiles; M over several row
    tiles."""
    g = torch.Generator(device=dev).manual_seed(m * 7919 + k * 31 + n)
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    qw = tmm.quantize(w)
    out = tmm.int8_matmul(x, qw)
    torch.cuda.synchronize()
    ref = tmm.reference_int8_matmul(x, qw)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert (out - ref).abs().max().item() < 1e-4


@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("k,n", [(768, 3072), (3072, 768), (768, 32768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_at_window_and_beam_rows(dev, m, k, n, dtype):
    """The rows of beam search (M = beam width 4) and of the speculative
    verify window (M = 8 slots x (spec_k + 1) = 32) at the flagship's FFN
    and head shapes."""
    g = torch.Generator(device=dev).manual_seed(m * 131 + n)
    qw = tmm.quantize(torch.randn((k, n), generator=g, device=dev)
                      * k ** -0.5)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    before = tmm.int8_matmul.launches
    out = tmm.int8_matmul(x, qw)
    torch.cuda.synchronize()
    assert tmm.int8_matmul.launches == before + 1
    assert (out - tmm.reference_int8_matmul(x, qw)).abs().max().item() < 1e-4


@pytest.mark.parametrize("quant", [False, True])
def test_decode_window_paged_kernels_match_plain(dev, quant, monkeypatch):
    """A speculative verify window over an int8 serving tree, float or
    int8 pages, in float32: through the ``int8_matmul`` kernel (M = B*W)
    against the same window through its plain version, on copies of one
    pool; logits within 1e-3, pools within 1e-5."""
    from deeplearning4j_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig(vocab_size=1000, d_model=256, n_heads=4,
                                n_layers=2, d_ff=1024, max_len=128,
                                dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(5)
    params = tmm.quantize_params_for_decode(
        ttr.init_params(g, cfg, dev), cfg)
    B, W, ps = 8, 4, 16
    n_slot = cfg.max_len // ps
    P = B * n_slot + 1
    if quant:
        pages = kv_quant.init_quantized_paged_cache(cfg, P, ps, "int8", dev)
    else:
        pages = ttr.init_paged_cache(cfg, P, ps, dev)
    bt = torch.randperm(P - 1, generator=g, device=dev)[:B * n_slot] \
        .reshape(B, n_slot).to(torch.int32)
    fill = torch.randint(0, cfg.vocab_size, (B, 40), generator=g, device=dev)
    for t in range(40):
        ttr.decode_step_paged(params, pages, bt, fill[:, t], t, cfg)
    toks = torch.randint(0, cfg.vocab_size, (B, W), generator=g, device=dev)
    pos = torch.tensor([40, 39, 38, 37, 36, 35, 126, 125], device=dev,
                       dtype=torch.int32)
    plain_pages = [{k: v.clone() for k, v in c.items()} for c in pages]
    before = tmm.int8_matmul.launches
    out, _ = ttr.decode_window_paged(params, pages, bt, toks, pos, cfg)
    torch.cuda.synchronize()
    # two FFN matmuls a layer and the head, each one launch at M = B * W
    assert tmm.int8_matmul.launches == before + 2 * cfg.n_layers + 1
    monkeypatch.setattr(ttr, "int8_matmul", tmm.reference_int8_matmul)
    ref, _ = ttr.decode_window_paged(params, plain_pages, bt, toks, pos, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() < 1e-3
    for a, b in zip(pages, plain_pages):
        for key in a:
            assert (a[key].float() - b[key].float()).abs().max().item() \
                <= (1 if key in ("k", "v") and quant else 1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_paths_make_no_host_sync(dev, quant):
    """The serving hot loop under ``torch.cuda.set_sync_debug_mode
    ("error")``: the paged step through the paged-attention kernel, the
    paged verify window, and a speculative engine's whole decode segment
    (noise draws for a sampled slot, draft steps, the verify window, the
    emission scatter), each through the kernels; any host sync raises."""
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ServingConfig)

    cfg = ttr.TransformerConfig(vocab_size=1000, d_model=256, n_heads=4,
                                n_layers=2, d_ff=1024, max_len=128)
    g = torch.Generator(device=dev).manual_seed(5)
    raw = ttr.init_params(g, cfg, dev)
    params = ttr.cast_for_decode(tmm.quantize_params_for_decode(raw, cfg),
                                 cfg)
    B, W, ps = 4, 4, 16
    n_slot = cfg.max_len // ps
    P = B * n_slot + 1
    if quant:
        pages = kv_quant.init_quantized_paged_cache(cfg, P, ps, "int8", dev)
        attn = tpa.paged_attention_int8
    else:
        pages = ttr.init_paged_cache(cfg, P, ps, dev)
        attn = tpa.paged_attention
    bt = torch.arange(B * n_slot, device=dev,
                      dtype=torch.int32).reshape(B, n_slot)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev)
    win = torch.randint(0, cfg.vocab_size, (B, W), generator=g, device=dev)
    pos = torch.tensor([5, 9, 40, cfg.max_len - 2], device=dev,
                       dtype=torch.int32)
    draft, dparams = zoo.draft_lm(cfg, device=dev)
    engine = InferenceEngine(
        ttr.TransformerLM(cfg, device=dev), raw,
        cfg=ServingConfig(slots=B, paged=True, page_size=ps, int8_decode=True,
                          speculative=True, spec_k=W - 1,
                          kv_quant="int8" if quant else None,
                          paged_attention_impl="cuda_int8" if quant
                          else "cuda"),
        draft_model=draft, draft_params=dparams, device=dev)

    def paths():
        ttr.decode_step_paged(params, pages, bt, tok, pos, cfg, attn_fn=attn)
        ttr.decode_window_paged(params, pages, bt, win, pos, cfg)
        return engine._decode_segment()

    with torch.no_grad():
        engine.warmup()                      # builds and loads the kernels
        paths()                              # first launches, outside
        h = engine.submit(list(range(1, 20)), 12, temperature=0.7, seed=3)
        engine._admit(engine._queue.take(1, block_s=0.0))
        slot, = engine._slots
        torch.cuda.synchronize()
        before = tmm.int8_matmul.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = paths()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert tmm.int8_matmul.launches > before
    em = torch.stack(out)
    assert em.shape == (engine.cfg.resolve_every, B, W)
    assert (em[:, slot, 0] >= 0).all()       # the sampled slot emitted
    assert not h.done()


def test_trainer_hot_loop_makes_no_host_sync(dev):
    """``DataParallelTrainer``'s dispatches between fences under
    ``torch.cuda.set_sync_debug_mode("error")``: a train step of the LM
    through the fused attention, fused LN and blocked xent kernels, fed
    by ``prefetch_to_device`` (pinned memory, a copy stream); the ring is
    read once, after."""
    from deeplearning4j_tpu_torch.datasets import prefetch_to_device
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    cfg = ttr.TransformerConfig(vocab_size=1000, d_model=256, n_heads=4,
                                n_layers=2, d_ff=1024, max_len=256,
                                attention="fused", fused_ln=True,
                                xent_impl="blocked")
    g = torch.Generator(device=dev).manual_seed(6)
    params = ttr.init_params(g, cfg, dev)
    trainer = DataParallelTrainer(
        lambda p, x, y, gen: ttr.lm_loss_local(p, x, y, cfg),
        TT.adamw(TT.warmup_cosine(1e-3, 2, 100)), device=dev)
    state = trainer.init_state(params)
    rng = np.random.default_rng(6)
    host = [(t, np.roll(t, -1, axis=1)) for t in
            (rng.integers(0, cfg.vocab_size, (4, 256)) for _ in range(4))]
    state, _ = trainer.step(state, *host[0])       # first call: warm-up
    trainer._resolve_pending()
    batches = list(prefetch_to_device(host[1:], device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x, y in batches:
            state, _ = trainer.step(state, x, y)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    vals = trainer._resolve_pending()
    assert len(vals) == 3 and all(np.isfinite(vals)) and state.step == 4


@pytest.mark.parametrize("m,n", [(1, 3072), (8, 768), (3, 17)])
def test_int8_matmul_kernel_misaligned_weights(dev, m, n):
    """A contiguous q starting one byte past a 16-byte boundary takes the
    byte loads."""
    g = torch.Generator(device=dev).manual_seed(n)
    k = 768
    qw = tmm.quantize(torch.randn((k, n), generator=g, device=dev) * 0.03)
    buf = torch.empty(k * n + 1, dtype=torch.int8, device=dev)
    q = buf[1:].view(k, n)
    q.copy_(qw.q)
    assert q.is_contiguous() and q.data_ptr() % 16 == 1
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    out = tmm.int8_matmul(x, tmm.QuantizedLinear(q, qw.scale))
    torch.cuda.synchronize()
    assert (out - tmm.reference_int8_matmul(x, qw)).abs().max().item() < 1e-4


@pytest.mark.parametrize("m,k,n", [(1, 3072, 768), (8, 3072, 768),
                                   (1, 768, 32768), (40, 4097, 3000)])
def test_int8_matmul_kernel_is_deterministic(dev, m, k, n):
    """K split over a cluster is merged in rank order: two calls agree
    bitwise."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    qw = tmm.quantize(torch.randn((k, n), generator=g, device=dev))
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    a = tmm.int8_matmul(x, qw)
    b = tmm.int8_matmul(x, qw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_int8_matmul_kernel_cuda_graph_replay(dev):
    """One call captured in a CUDA graph and replayed after x changes in
    place."""
    g = torch.Generator(device=dev).manual_seed(21)
    k, n = 3072, 768
    qw = tmm.quantize(torch.randn((k, n), generator=g, device=dev) * 0.02)
    x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tmm.int8_matmul(x, qw)           # warm up on the capture stream
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = tmm.int8_matmul(x, qw)
    torch.cuda.current_stream().wait_stream(stream)
    for seed in range(3):
        x.copy_(torch.randn((1, k), generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        ref = tmm.reference_int8_matmul(x, qw)
        assert (out - ref).abs().max().item() < 1e-4


@pytest.mark.parametrize("m,k,n", [(1, 3072, 768), (8, 768, 32768)])
def test_int8_matmul_kernel_is_one_launch(dev, m, k, n):
    """A call is one device kernel, with K split or not."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(2)
    qw = tmm.quantize(torch.randn((k, n), generator=g, device=dev))
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    tmm.int8_matmul(x, qw)
    torch.cuda.synchronize()
    for _ in range(3):   # a session that saw no kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tmm.int8_matmul(x, qw)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "int8_gemv_kernel" in kernels[0], kernels


@pytest.mark.parametrize("m,k,n", [(1, 768, 3072), (8, 3072, 768),
                                   (3, 100, 17)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_input_grad_matches_plain(dev, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(m + k)
    w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    c = torch.randn((m, n), generator=g, device=dev)
    qw = tmm.quantize(w)
    xk = x.clone().requires_grad_(True)
    before = tmm.int8_matmul.launches
    (tmm.int8_matmul(xk, qw) * c).sum().backward()
    torch.cuda.synchronize()
    assert tmm.int8_matmul.launches == before + 1
    xp = x.clone().requires_grad_(True)
    (tmm.reference_int8_matmul(xp, qw) * c).sum().backward()
    assert xk.grad.dtype == dtype and xk.grad.shape == x.shape
    # f32 gradients in both, summation order apart; bf16 ones round once
    # to x's dtype, so f32 values a hair apart may round one ulp apart
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    ref = xp.grad.float()
    assert ((xk.grad.float() - ref).abs() <= 1e-4 + tol * ref.abs()).all()


@pytest.mark.parametrize("B,H,Kv,quant", [
    (4, 12, 12, False), (4, 12, 4, False), (4, 12, 12, True), (4, 12, 1, True),
    (4, 12, 2, False), (4, 16, 1, False),       # groups of 6 and 16 heads
    (48, 12, 12, False)])    # 48 x 12 rows: one page split, no merge pass
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_matches_plain(dev, B, H, Kv, quant, dtype):
    g = torch.Generator(device=dev).manual_seed(H * Kv + B)
    Dh, ps, n_pages = 64, 16, 8
    P = B * n_pages + 1
    k = torch.randn((P, ps, Kv, Dh), generator=g, device=dev)
    v = torch.randn((P, ps, Kv, Dh), generator=g, device=dev)
    q = torch.randn((B, H, Dh), generator=g, device=dev).to(dtype)
    bt = torch.randperm(P - 1, generator=g, device=dev)[:B * n_pages] \
        .reshape(B, n_pages).to(torch.int32)
    bt[3] = P - 1                                   # an inactive row
    lengths = torch.tensor([1, 37, n_pages * ps, 5] * (B // 4),
                           dtype=torch.int32, device=dev)
    if quant:
        s0 = torch.full((P, Kv), 1 / 127, device=dev)
        kq, ks = kv_quant.requantize_pool(k, s0, torch.int8)
        vq, vs = kv_quant.requantize_pool(v, s0, torch.int8)
        out = tpa.paged_attention_int8(q, kq, vq, ks, vs, bt, lengths)
        ref = tpa.reference_paged_attention_int8(q.float(), kq, vq, ks, vs,
                                                 bt, lengths)
    else:
        kb, vb = k.to(dtype), v.to(dtype)
        out = tpa.paged_attention(q, kb, vb, bt, lengths)
        ref = tpa.reference_paged_attention(q.float(), kb.float(), vb.float(),
                                            bt, lengths)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    # against the plain version in float32 on the same values: the kernel
    # accumulates in f32, so it differs by summation order and, in bf16,
    # by its one rounding of the output (half a unit in the last place)
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() < 1e-4
    else:
        assert (err <= 1e-5 + 2 ** -8 * ref.abs()).all().item()


def _paged_pools(dev, g, B, H, Kv, Dh, ps, n_pages, lengths, quant, dtype):
    """Random pools and a block table for ``lengths`` (a row of length 0
    is an inactive slot: length 1 over the trash page); returns the kernel
    arguments and the plain version's, in float32 on the same values."""
    P = B * n_pages + 1
    k = torch.randn((P, ps, Kv, Dh), generator=g, device=dev)
    v = torch.randn((P, ps, Kv, Dh), generator=g, device=dev)
    q = torch.randn((B, H, Dh), generator=g, device=dev).to(dtype)
    bt = torch.randperm(P - 1, generator=g, device=dev)[:B * n_pages] \
        .reshape(B, n_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    need = (lens + ps - 1) // ps
    bt = torch.where(torch.arange(n_pages, device=dev)[None, :]
                     < need[:, None], bt, torch.full_like(bt, P - 1))
    lens = lens.clamp(min=1)
    if quant:
        s0 = torch.full((P, Kv), 1 / 127, device=dev)
        kq, ks = kv_quant.requantize_pool(k, s0, torch.int8)
        vq, vs = kv_quant.requantize_pool(v, s0, torch.int8)
        return ((q, kq, vq, ks, vs, bt, lens),
                (q.float(), kq, vq, ks, vs, bt, lens))
    kb, vb = k.to(dtype), v.to(dtype)
    return (q, kb, vb, bt, lens), (q.float(), kb.float(), vb.float(), bt, lens)


def _paged_fns(quant):
    if quant:
        return tpa.paged_attention_int8, tpa.reference_paged_attention_int8
    return tpa.paged_attention, tpa.reference_paged_attention


def _assert_paged_close(out, ref, dtype):
    # against the plain version in float32 on the same values: summation
    # order and, in bf16, one rounding of the output (half an ulp)
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() < 1e-4
    else:
        assert (err <= 1e-5 + 2 ** -8 * ref.abs()).all().item()


def _lengths(kind, B, full, seed):
    rng = torch.Generator().manual_seed(seed)
    if kind == "ragged":        # a row of 1 beside full-table rows, a trash row
        base = [1, full, 0, full - 5]
        return [base[i % 4] for i in range(B)]
    if kind == "ones":
        return [1] * B
    if kind == "full":
        return [full] * B
    return torch.randint(1, full + 1, (B,), generator=rng).tolist()


@pytest.mark.parametrize("B,H,Kv,Dh,ps,n_pages,kind", [
    (4, 12, 12, 64, 16, 128, "ragged"),     # lengths 1 and 2048 in one batch
    (8, 12, 12, 64, 16, 128, "ones"),       # every row of length 1
    (1, 12, 12, 64, 16, 128, "full"),       # one row over the whole table
    (64, 12, 12, 64, 16, 32, "random"),     # more rows than fit one a block
    (3, 32, 32, 128, 64, 4, "ragged"),      # a page (512 KB) > a stage
    (5, 8, 8, 32, 64, 6, "random"),         # ps 64, Dh 32
    (4, 8, 4, 128, 16, 16, "ragged"),       # Dh 128, groups of 2
    (4, 12, 12, 32, 16, 16, "random"),      # groups of 1, Dh 32
    (4, 12, 2, 64, 16, 24, "ragged"),       # groups of 6
    (4, 16, 1, 64, 16, 24, "ragged")])      # groups of 16 (MQA)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_ragged_shapes(dev, B, H, Kv, Dh, ps, n_pages,
                                              kind, quant, dtype):
    g = torch.Generator(device=dev).manual_seed(B * 100 + H + Dh + ps)
    lengths = _lengths(kind, B, n_pages * ps, B + Dh)
    args, ref_args = _paged_pools(dev, g, B, H, Kv, Dh, ps, n_pages, lengths,
                                  quant, dtype)
    kern, plain = _paged_fns(quant)
    before = kern.launches
    out = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, H, Dh)
    _assert_paged_close(out, plain(*ref_args), dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_kernel_is_deterministic(dev, quant):
    """Rows split over many blocks merge in a fixed order: two calls on
    the same inputs agree bitwise (and the tickets are left at 0)."""
    g = torch.Generator(device=dev).manual_seed(11)
    lengths = _lengths("random", 8, 2048, 3) + [2048, 1]
    args, _ = _paged_pools(dev, g, 10, 12, 12, 64, 16, 128, lengths, quant,
                           torch.bfloat16)
    kern, _ = _paged_fns(quant)
    a = kern(*args)
    b = kern(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert int(tpa._tickets(args[0].device, 10).abs().sum().item()) == 0


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_kernel_cuda_graph_replay(dev, quant):
    """One call captured in a CUDA graph and replayed after ``lengths``
    changes in place: the kernel splits the new lengths on the device."""
    g = torch.Generator(device=dev).manual_seed(12)
    B, n_pages, ps = 8, 128, 16
    full = n_pages * ps
    args, ref_args = _paged_pools(dev, g, B, 12, 12, 64, ps, n_pages,
                                  [full] * B, quant, torch.bfloat16)
    kern, plain = _paged_fns(quant)
    lengths = args[-1]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        kern(*args)                      # warm up on the capture stream
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = kern(*args)
    torch.cuda.current_stream().wait_stream(stream)
    for new in ([1, full, 37, 300, 1, 2000, 16, 17],
                [5] * B, _lengths("random", B, full, 4)):
        lengths.copy_(torch.tensor(new, dtype=torch.int32, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        _assert_paged_close(out, plain(*ref_args), torch.bfloat16)


# ------------------------------------------------------------ training kernels

@pytest.mark.parametrize("B,T,H,Dh,causal,frontier", [
    (2, 128, 3, 64, False, False), (2, 256, 2, 64, True, False),
    (2, 256, 2, 64, True, True),
    # T not a multiple of the 128-row tiles: rows past T load as zeros
    (1, 100, 2, 32, True, True), (2, 300, 2, 32, True, False),
    (1, 100, 1, 64, True, False), (1, 300, 1, 128, True, True),  # B*H = 1
    (1, 192, 2, 128, False, True), (3, 64, 4, 64, True, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_matches_plain(dev, B, T, H, Dh, causal, frontier,
                                        dtype):
    from deeplearning4j_tpu_torch.ops.cuda import attention as tat
    g = torch.Generator(device=dev).manual_seed(T + H)
    # q/k/v as the strided views of one packed (B,T,3,H,Dh) projection
    qkv = torch.randn((B, T, 3, H, Dh), generator=g, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    wrapper = tat.fused_attention if frontier else tat.flash_attention
    before = wrapper.launches
    out, lse = tat.attention_fwd(q, k, v, causal=causal, frontier=frontier)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref, ref_lse = tat.reference_flash_fwd(q.float(), k.float(), v.float(),
                                           causal)
    assert out.dtype == dtype and out.shape == q.shape
    # against the plain version run in f32 on the same values.  f32:
    # summation order only.  bf16: rounding each p to bf16 for the
    # tensor-core P V moves the output by at most half an ulp of
    # sum(p |v|) / l (the plain version on |v|), and the output rounds once
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() < 1e-5
    else:
        ref_abs, _ = tat.reference_flash_fwd(q.float(), k.float(),
                                             v.float().abs(), causal)
        assert (err <= 1e-5 + 2 ** -8 * (ref_abs + ref.abs())).all().item()
    assert (lse - ref_lse).abs().max().item() < 1e-5


@pytest.mark.parametrize("N,D", [(37, 768), (4096, 768), (8, 64), (5, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_residual_layernorm_kernel_matches_plain(dev, N, D, dtype):
    from deeplearning4j_tpu_torch.ops.cuda import layernorm as tln
    g = torch.Generator(device=dev).manual_seed(N + D)
    x = torch.randn((N, D), generator=g, device=dev).to(dtype)
    r = torch.randn((N, D), generator=g, device=dev).to(dtype)
    m = (torch.rand((N, 1), generator=g, device=dev) > 0.2).float() / 0.8
    s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
    b = 0.1 * torch.randn((D,), generator=g, device=dev)
    before = tln.fused_residual_layernorm.launches
    y, h = tln.residual_layernorm_fwd(x, r, m, s, b)
    torch.cuda.synchronize()
    assert tln.fused_residual_layernorm.launches == before + 1
    ry, rh = tln.reference_residual_layernorm(x, r, s, b, mask=m)
    # the same f32 arithmetic, rounded once to the output dtype: at most
    # one unit in the last place apart where the f32 sums round apart
    ulp = 1e-5 if dtype == torch.float32 else 2 ** -7
    for a, ref in ((y, ry), (h, rh)):
        assert ((a.float() - ref.float()).abs()
                <= 1e-5 + ulp * ref.float().abs()).all().item()


def test_blocked_xent_backward_is_deterministic(dev):
    """Repeated targets: the backward sums each head column's gold terms in
    token order, so two backwards (one queued behind other work on the
    stream) give the same bits, and the gradients match the plain loss's."""
    from deeplearning4j_tpu_torch.ops.cuda import xent as txe
    g = torch.Generator(device=dev).manual_seed(3)
    N, V, D = 4096, 32768, 768
    h = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    emb = (0.02 * torch.randn((V, D), generator=g, device=dev))
    tg = torch.randint(0, 64, (N,), generator=g, device=dev)  # many repeats

    def grads():
        hh = h.detach().requires_grad_(True)
        ee = emb.detach().requires_grad_(True)
        loss = txe.blocked_cross_entropy(hh, ee.to(torch.bfloat16).T, tg)
        return torch.autograd.grad(loss, (hh, ee))

    first = grads()
    torch.cuda.synchronize()
    busy = torch.randn((8192, 8192), generator=g, device=dev)
    busy @ busy                                   # queued ahead of the call
    second = grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    hh = h.float().detach().requires_grad_(True)
    ee = emb.detach().requires_grad_(True)
    ref = txe.reference_xent_sum(hh, ee.to(torch.bfloat16).float().T, tg)
    rh, re = torch.autograd.grad(ref, (hh, ee))
    assert (first[0].float() - rh).abs().max() <= 0.02 * rh.abs().max()
    assert (first[1] - re).abs().max() <= 0.02 * re.abs().max()


@pytest.mark.parametrize("N,V,D", [
    (37, 101, 64), (300, 1000, 128), (2048, 32768, 768), (129, 257, 40),
    (1, 50257, 768),          # one token: the vocabulary split over the SMs
    (37, 1000, 2048),         # h too wide to stay resident: streamed
    (32768, 1000, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tied", [True, False])
def test_blocked_xent_kernel_matches_plain(dev, N, V, D, dtype, tied):
    from deeplearning4j_tpu_torch.ops.cuda import xent as txe
    g = torch.Generator(device=dev).manual_seed(N + V)
    h = torch.randn((N, D), generator=g, device=dev).to(dtype)
    emb = 0.5 * torch.randn((V, D), generator=g, device=dev)
    # tied: tok_embed^T read through its strides; else a row-major (D, V)
    # (V % 8 != 0: the wrapper pads a copy for the bf16 kernel's TMA map)
    head = emb.to(dtype).T if tied else emb.T.contiguous().to(dtype)
    tg = torch.randint(0, V, (N,), generator=g, device=dev,
                       dtype=torch.int32)
    tg[1:2] = 0                                  # the first column
    tg[2:3] = V - 1                              # the last column
    w = torch.rand((N,), generator=g, device=dev)
    w[0] = 0.0
    before = txe.blocked_cross_entropy.launches
    wloss, lse = txe.xent_fwd(h, head, tg, w)
    torch.cuda.synchronize()
    assert txe.blocked_cross_entropy.launches == before + 1
    rw, rl = txe.reference_xent_rows(h, head, tg, w)
    # bf16 products are exact in the f32 accumulators: both sides differ by
    # summation order only (f32 inputs: the f32 FMA path)
    assert (lse - rl).abs().max().item() < 2e-5 * (1 + rl.abs().max().item())
    assert (wloss - rw).abs().max().item() < 2e-5 * (1 + rw.abs().max().item())
    assert wloss[0].item() == 0.0
