"""Paged-attention decode: K/V read through block tables.

Port of ``deeplearning4j_tpu/ops/pallas/paged_attention.py``.  The paged
serving decode stores K/V as fixed-size pages in ``(num_pages,
page_size, Kv, Dh)`` pools and addresses each sequence through a
``(B, n_pages)`` block table.

- :func:`reference_paged_attention` / :func:`reference_paged_attention_int8`
  are the plain versions: gather each row's pages into a dense
  ``(B, T, H, Dh)`` view and run the dense decode attention ops over it.
  They are the incumbents ``gather`` / ``gather_int8`` and the ground
  truth the kernels are held to.
- :func:`paged_attention` / :func:`paged_attention_int8` are the kernel
  wrappers (``csrc/paged_attention.cu``, one template with a dequantize
  flag and the page type), registered as ``cuda`` / ``cuda_int8``; the
  quantized kind takes int8 or fp8 (``float8_e4m3fn``) pages, as the
  reference's does.  On CUDA tensors they
  launch the kernel and count the launch in ``<wrapper>.launches``; on
  CPU tensors they compute the plain version.  No fallback from the
  kernel to the plain version.

The kernel is one launch of one block per SM that splits the batch's
valid pages evenly over the blocks on the device (from ``lengths``, with
no host sync).  A row splits into chunks of whole pages that depend on
its own length only (at most :data:`MAX_CHUNKS`), each chunk a partial
softmax state, merged in chunk order by the block that finishes the row
last: a row's output is bitwise the same whatever else the batch holds.
That merge counts arrivals in an int32 ticket per row, which the kernel
leaves at 0: :func:`_tickets` keeps one zeroed buffer per
(device, stream), made on the first call outside a CUDA-graph capture
and never freed, so a captured call replays against the same buffer.

Kv < H is GQA/MQA: query head ``h`` reads kv head ``h // (H // Kv)``.
"""

from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from ...device import sm_count
from ...observability.cost import kernel_work
from . import build, kv_quant, registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the kernel's page-type codes of the quantized pools (0: the model dtype)
_PAGE_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: dl4j_paged_attention(q, k, v, k_scale, v_scale, bt, lengths, out,
#: part, tickets, B, H, Kv, Dh, ps, n_pages, n_blocks, max_chunks, dtype,
#: page type, stream)
_ARGTYPES = [_P] * 10 + [_I] * 10 + [_P]
#: the most chunks (partial softmax states) a row splits into: a row of
#: ``pages`` pages splits into chunks of ceil(pages / MAX_CHUNKS) pages
MAX_CHUNKS = 32


def reference_paged_attention(q, k_pages, v_pages, block_tables, lengths,
                              **_):
    """Gather each row's pages to a dense (B, T, H, Dh) view and run the
    dense decode attention over it.  ``q`` (B, H, Dh), pools (P, ps, Kv,
    Dh), ``block_tables`` (B, n_pages) page ids, ``lengths`` (B,) valid
    K/V prefix per row (>= 1).  Returns (B, H, Dh) in ``q``'s dtype."""
    ps = k_pages.shape[1]
    B = q.shape[0]
    T = block_tables.shape[1] * ps
    scale = q.shape[-1] ** -0.5
    t = torch.arange(T, device=q.device).expand(B, T)
    flat = (torch.gather(block_tables.long(), 1, t // ps) * ps + t % ps)
    k = k_pages.reshape((-1,) + tuple(k_pages.shape[2:]))[flat]
    v = v_pages.reshape((-1,) + tuple(v_pages.shape[2:]))[flat]
    n_rep = q.shape[1] // k.shape[2]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    s = s.masked_fill(~(t < lengths.long()[:, None])[:, None, :],
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def reference_paged_attention_int8(q, k_pages, v_pages, k_scale, v_scale,
                                   block_tables, lengths, **_):
    """Plain version of the quantized kind: dequantize the whole pool
    through :mod:`kv_quant`, then :func:`reference_paged_attention`."""
    kf = kv_quant.dequantize_pool(k_pages, k_scale, q.dtype)
    vf = kv_quant.dequantize_pool(v_pages, v_scale, q.dtype)
    return reference_paged_attention(q, kf, vf, block_tables, lengths)


def _blocks(device, B: int, n_pages: int, ps: int) -> int:
    """Blocks of a launch: one per SM (each takes a share of the batch's
    valid positions on the device), never more than the table's
    positions."""
    return max(1, min(sm_count(device), B * n_pages * ps))


_ticket_bufs: dict = {}


def _tickets(device, B: int) -> torch.Tensor:
    """The zeroed int32 row tickets of the current stream, at least ``B``
    long.  A buffer outgrown is kept alive, since a captured CUDA graph
    may still replay against it."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device, stream.cuda_stream)
    bufs = _ticket_bufs.setdefault(key, [])
    if not bufs or bufs[-1].numel() < B:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged attention: the first call on a stream (or with a "
                "larger batch) must run outside a CUDA-graph capture: it "
                "allocates and zeroes the kernel's row tickets")
        bufs.append(torch.zeros(max(B, 64), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _launch(q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
            quant: bool) -> torch.Tensor:
    what = "paged_attention_int8" if quant else "paged_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be (B,H,Dh) and "
                         f"the pools (P,ps,Kv,Dh), got {tuple(k_pages.shape)}"
                         f" / {tuple(v_pages.shape)}")
    B, H, Dh = q.shape
    _, ps, Kv, Dh_k = k_pages.shape
    if Dh_k != Dh or H % Kv or H // Kv > 16:
        raise ValueError(f"{what}: pool heads/width {Kv}/{Dh_k} do not fit "
                         f"q heads/width {H}/{Dh} (H/Kv at most 16)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: q dtype {q.dtype} not supported")
    if quant:
        if k_pages.dtype not in _PAGE_CODES or v_pages.dtype != k_pages.dtype:
            raise TypeError(f"{what}: pools must both be int8 or "
                            f"float8_e4m3fn, got {k_pages.dtype}/"
                            f"{v_pages.dtype}")
        page_code = _PAGE_CODES[k_pages.dtype]
    else:
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise TypeError(f"{what}: pools must be {q.dtype}, got "
                            f"{k_pages.dtype}/{v_pages.dtype}")
        page_code = 0
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{what}: block_tables and lengths must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"{what}: block_tables {tuple(block_tables.shape)} "
                         f"/ lengths {tuple(lengths.shape)} do not fit B={B}")
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if quant:
        P = k_pages.shape[0]
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (P, Kv):
                raise ValueError(f"{what}: scales must be float32 ({P}, {Kv})")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if Dh not in (32, 64, 128):
        raise ValueError(f"{what}: head width {Dh} not in (32, 64, 128)")
    for t in (q, k_pages, v_pages):     # bulk copies move 16-byte units
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: q and the pools must be 16-byte "
                             "aligned")
    n_pages = block_tables.shape[1]
    n_blocks = _blocks(q.device, B, n_pages, ps)
    # the same chunks as MAX_CHUNKS itself (a row has at most n_pages
    # pages), and as few partial slots as the table needs
    max_chunks = min(MAX_CHUNKS, n_pages)
    out = torch.empty_like(q)
    # per row max_chunks (m, l, acc) partials, each padded to 16 bytes
    part = torch.empty((B * max_chunks, H * Dh + -(-2 * H // 4) * 4),
                       dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, B)
    fn = build.function("paged_attention", "dl4j_paged_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), B, H, Kv, Dh, ps,
            n_pages, n_blocks, max_chunks, _DTYPE_CODES[q.dtype], page_code,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", rc, what)
    return out


def _counted(q, k_pages, block_tables, quant: bool) -> torch.Tensor:
    """The fake branch (a cost count, ``observability.cost``): flops and
    bytes over every position the block tables address (the lengths are
    data; the kernel stops at each row's), an empty output, no launch."""
    B, H, Dh = q.shape
    _, ps, Kv, _ = k_pages.shape
    n_pages = block_tables.shape[1]
    positions = B * n_pages * ps
    nbytes = (2 * positions * Kv * Dh * k_pages.element_size()
              + 2 * q.numel() * q.element_size() + block_tables.numel() * 4
              + B * 4 + (2 * B * n_pages * Kv * 4 if quant else 0))
    kernel_work(4 * positions * H * Dh, nbytes)
    return torch.empty_like(q)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    interpret: bool | None = None):
    """Paged decode attention; same contract as
    :func:`reference_paged_attention` within the registered tolerance
    (the running softmax reassociates the reduction, so not bitwise).
    ``interpret``, the reference's Pallas mode, is accepted and ignored:
    a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return reference_paged_attention(q, k_pages, v_pages, block_tables,
                                         lengths)
    if is_fake(q):
        return _counted(q, k_pages, block_tables, quant=False)
    out = _launch(q, k_pages, v_pages, None, None, block_tables, lengths,
                  quant=False)
    paged_attention.launches += 1
    return out


def paged_attention_int8(q, k_pages, v_pages, k_scale, v_scale,
                         block_tables, lengths, *,
                         interpret: bool | None = None):
    """Paged decode attention over int8 or fp8 (``float8_e4m3fn``) pages
    with per-(page, kv_head) f32 scales, dequantized inside the kernel;
    same contract as
    :func:`reference_paged_attention_int8` within the registered
    tolerance."""
    if q.device.type == "cpu":
        return reference_paged_attention_int8(q, k_pages, v_pages, k_scale,
                                              v_scale, block_tables, lengths)
    if is_fake(q):
        return _counted(q, k_pages, block_tables, quant=True)
    out = _launch(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                  lengths, quant=True)
    paged_attention_int8.launches += 1
    return out


paged_attention.launches = 0
paged_attention_int8.launches = 0


registry.register(registry.KernelCandidate(
    kind="paged_attention", name="cuda", fn=paged_attention,
    reference=reference_paged_attention,
    blocks=({},),              # the page size IS the block: nothing to sweep
    tolerances={"max_err": 0.05},
))

registry.register(registry.KernelCandidate(
    kind="paged_attention", name="gather", fn=reference_paged_attention,
    reference=reference_paged_attention, source="torch",
))

registry.register(registry.KernelCandidate(
    kind="paged_attention_int8", name="cuda_int8", fn=paged_attention_int8,
    reference=reference_paged_attention_int8,
    blocks=({},),
    # same numeric band as the float kind, PLUS the served-token agreement
    # floor the int8 weight path enforces
    tolerances={"max_err": 0.05, "min": {"top1_agree": 0.999}},
))

registry.register(registry.KernelCandidate(
    kind="paged_attention_int8", name="gather_int8",
    fn=reference_paged_attention_int8,
    reference=reference_paged_attention_int8, source="torch",
))
