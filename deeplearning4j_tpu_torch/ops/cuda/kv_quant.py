"""KV-cache quantization helpers: per-page, per-head absmax scales.

Port of ``deeplearning4j_tpu/ops/pallas/kv_quant.py``.  Storage is int8
or fp8 (``torch.float8_e4m3fn``) with one f32 scale per (page, kv_head):
``scale[p, h] = max(|page[p, :, h, :]|) / qmax`` (127 for int8, 448, the
largest finite e4m3 value, for fp8), so dequantization inside the
paged-attention read is one multiply per page and head.

Scales are MONOTONE per page — :func:`requantize_pool` takes
``max(old_scale, amax/qmax)`` — so a page whose content did not change
requantizes to byte-identical storage, and repeated single-token writes
never drift the untouched rest of the pool.  A freed page's scale resets
to :func:`neutral_scale`.  Every op here is bitwise the JAX package's:
the same IEEE f32 arithmetic, ``torch.round`` rounds half to even as
``jnp.round`` does (int8 only), and the fp8 cast rounds to nearest even
after the clamp, as ``astype`` does.  e4m3 has no infinity and an
unclamped value past 448 becomes NaN, so every cast to fp8 goes through
:func:`cast_to`.

On this CPU build ``index_copy_`` and ``torch.equal`` are not implemented
for ``float8_e4m3fn``: scatter into an fp8 pool with ``index_put_`` and
compare fp8 pools through ``.view(torch.uint8)``.
"""

from __future__ import annotations

import torch

from ...device import resolve_device

#: kv_quant modes ServingConfig accepts in this package
KV_QUANT_MODES = ("int8", "fp8")

_STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_QMAX = {torch.int8: 127.0,
         torch.float8_e4m3fn: 448.0}   # float8_e4m3fn finite max


def storage_dtype(mode: str) -> torch.dtype:
    """The on-device dtype of a quantized KV page for ``mode``."""
    try:
        return _STORAGE[mode]
    except (KeyError, TypeError):
        raise ValueError(f"unknown kv_quant mode {mode!r} (supported: "
                         f"{KV_QUANT_MODES})") from None


def qmax(dtype: torch.dtype) -> float:
    """Largest magnitude the absmax scale maps onto for ``dtype``."""
    try:
        return _QMAX[dtype]
    except KeyError:
        raise ValueError(f"not a KV storage dtype: {dtype!r}") from None


def neutral_scale(dtype: torch.dtype) -> float:
    """Scale of an all-zero (freshly wiped) page: positive so dequant is
    division-safe, and MINIMAL so the monotone per-page running max only
    grows from real content."""
    return 1.0 / qmax(dtype)


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Saturating cast of already-scaled f32 values into the storage
    dtype — the one place a raw KV precision cast happens."""
    m = qmax(dtype)
    x = torch.clamp(x, -m, m)
    if dtype == torch.int8:
        x = torch.round(x)
    return x.to(dtype)


def init_quantized_paged_cache(cfg, num_pages: int, page_size: int,
                               mode: str, device=None) -> list:
    """Quantized twin of ``transformer.init_paged_cache``: per-layer
    int8/fp8 K/V pools ``(num_pages, page_size, n_kv_heads, Dh)`` plus
    ``(num_pages, n_kv_heads)`` f32 scales for each of k and v.  Key
    presence (``k_scale``) is how every consumer detects a quantized
    pool.  The pools go to ``device`` (default CUDA, which raises without
    a GPU)."""
    device = resolve_device(device)
    dt = storage_dtype(mode)
    kvh = cfg.kv_heads
    shape = (num_pages, page_size, kvh, cfg.head_dim)

    def s0():
        return torch.full((num_pages, kvh), neutral_scale(dt),
                          dtype=torch.float32, device=device)

    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device),
             "k_scale": s0(), "v_scale": s0()}
            for _ in range(cfg.n_layers)]


def dequantize_pool(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(P, ps, K, Dh)`` storage × ``(P, K)`` scales → ``dtype`` pool."""
    return (q.to(torch.float32) * scale[:, None, :, None]).to(dtype)


def requantize_pool(f: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype):
    """Quantize a float pool back into storage against monotone per-page
    per-head absmax scales; returns ``(storage pool, new scales)``.

    ``amax / qmax`` divides by a tensor: CUDA divides a tensor by a
    Python scalar as a multiply by its rounded reciprocal, which can land
    one ulp above the true quotient, so a page whose largest element
    stores as exactly ``qmax`` would grow its scale by an ulp at every
    write to the pool, and a request's K/V would depend on how many writes
    its pages lived through."""
    f32 = f.to(torch.float32)
    amax = torch.amax(torch.abs(f32), dim=(1, 3))
    s = torch.maximum(scale, amax / torch.full_like(amax, qmax(dtype)))
    return cast_to(f32 / s[:, None, :, None], dtype), s


def kv_itemsize(mode: str | None, model_dtype: torch.dtype) -> int:
    """Bytes per stored K/V element under ``mode`` (None = the model's
    dtype) — the gauge layer's accounting."""
    dt = model_dtype if mode is None else storage_dtype(mode)
    return torch.empty((), dtype=dt).element_size()
