"""KV-cache quantization helpers: per-page, per-head absmax scales.

Port of ``deeplearning4j_tpu/ops/pallas/kv_quant.py`` (int8 only; fp8
storage is not ported yet and ``storage_dtype("fp8")`` raises, as the JAX
package does on a build without float8).  Storage is int8 with one f32
scale per (page, kv_head): ``scale[p, h] = max(|page[p, :, h, :]|) /
127``, so dequantization inside the paged-attention read is one multiply
per page and head.

Scales are MONOTONE per page — :func:`requantize_pool` takes
``max(old_scale, amax/qmax)`` — so a page whose content did not change
requantizes to byte-identical storage, and repeated single-token writes
never drift the untouched rest of the pool.  A freed page's scale resets
to :func:`neutral_scale`.  Every op here is bitwise the JAX package's:
the same IEEE f32 arithmetic, and ``torch.round`` rounds half to even as
``jnp.round`` does.
"""

from __future__ import annotations

import torch

#: kv_quant modes ServingConfig accepts in this package
KV_QUANT_MODES = ("int8",)


def storage_dtype(mode: str) -> torch.dtype:
    """The on-device dtype of a quantized KV page for ``mode``."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        raise ValueError("kv_quant='fp8' is not ported to "
                         "deeplearning4j_tpu_torch yet (ROADMAP.md A6: "
                         "fp8 KV pages)")
    raise ValueError(
        f"unknown kv_quant mode {mode!r} (supported: {KV_QUANT_MODES})")


def qmax(dtype: torch.dtype) -> float:
    """Largest magnitude the absmax scale maps onto for ``dtype``."""
    if dtype == torch.int8:
        return 127.0
    raise ValueError(f"not a KV storage dtype: {dtype!r}")


def neutral_scale(dtype: torch.dtype) -> float:
    """Scale of an all-zero (freshly wiped) page: positive so dequant is
    division-safe, and MINIMAL so the monotone per-page running max only
    grows from real content."""
    return 1.0 / qmax(dtype)


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Saturating cast of already-scaled f32 values into the storage
    dtype — the one place a raw KV precision cast happens."""
    m = qmax(dtype)
    return torch.round(torch.clamp(x, -m, m)).to(dtype)


def init_quantized_paged_cache(cfg, num_pages: int, page_size: int,
                               mode: str, device) -> list:
    """Quantized twin of ``transformer.init_paged_cache``: per-layer int8
    K/V pools ``(num_pages, page_size, n_kv_heads, Dh)`` plus
    ``(num_pages, n_kv_heads)`` f32 scales for each of k and v.  Key
    presence (``k_scale``) is how every consumer detects a quantized
    pool."""
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
    per-head absmax scales; returns ``(storage pool, new scales)``."""
    f32 = f.to(torch.float32)
    amax = torch.amax(torch.abs(f32), dim=(1, 3))
    s = torch.maximum(scale, amax / qmax(dtype))
    return cast_to(f32 / s[:, None, :, None], dtype), s


def kv_itemsize(mode: str | None, model_dtype: torch.dtype) -> int:
    """Bytes per stored K/V element under ``mode`` (None = the model's
    dtype) — the gauge layer's accounting."""
    dt = model_dtype if mode is None else storage_dtype(mode)
    return torch.empty((), dtype=dt).element_size()
