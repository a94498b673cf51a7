"""Multi-rank sharding dryrun: one full SPMD train step on tiny shapes over
an n-rank mesh (dp/pp/tp/sp: the GPipe micro-batch pipeline over pp,
Megatron tensor parallelism, ring attention over sp, the dp gradient
mean), then ZeRO-1 on the same mesh, then the ring with pp folded into
sp.

Port of ``deeplearning4j_tpu/parallel/dryrun.py``.  A device of the
reference is a rank here: :func:`dryrun_multichip` runs inside a process
group of at least ``n_devices`` ranks (every rank calls it), and
:func:`run_dryrun` — behind ``python -m deeplearning4j_tpu_torch dryrun
--devices N`` — spawns those ranks itself, over gloo through a
``file://`` store, on the CPU or all on one card (NCCL refuses two ranks
on one GPU).  The first rank prints the reference's ``dryrun_multichip
OK: ...`` line.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from pathlib import Path

from .mesh import DEFAULT_TIMEOUT_S


def mesh_spec_for(n_devices: int):
    """Factor n into (dp, pp, tp, sp): peel 2s round-robin so every
    parallelism kind is exercised when n allows (8 -> dp2·pp2·tp2,
    16 -> + sp2).  ep is exercised by the sharded-embedding path
    (``text.sharded_embedding``) rather than the flagship step."""
    from .mesh import DP, PP, SP, TP, MeshSpec
    dims = {DP: 1, PP: 1, TP: 1, SP: 1}
    order = [DP, PP, TP, SP]
    n, i = n_devices, 0
    while n % 2 == 0 and n > 1:
        dims[order[i % 4]] *= 2
        n //= 2
        i += 1
    dims[DP] *= n  # odd residue onto dp
    return MeshSpec(dp=dims[DP], sp=dims[SP], tp=dims[TP],
                    pp=dims[PP], ep=1)


def _finite(x: float, what: str) -> float:
    if x != x or x in (float("inf"), float("-inf")):
        raise RuntimeError(f"non-finite {what} {x}")
    return x


def dryrun_multichip(n_devices: int, device=None) -> str:
    """One full sharded train step on tiny shapes over the world's first
    ``n_devices`` ranks, ZeRO-1 on the same mesh, and the ring leg; every
    rank of the world calls it (the meshes are collective).  Returns the
    OK line (printed by the first rank); raises on a non-finite loss."""
    import torch

    from ..models.transformer import TransformerConfig, TransformerLM
    from ..optimize import transforms as T
    from .mesh import (DP, PP, SP, TP, MeshSpec, make_mesh, rank_devices,
                       world_rank)

    devices = rank_devices()
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} ranks, have {len(devices)} "
                           "(python -m deeplearning4j_tpu_torch dryrun "
                           "spawns them)")
    spec = mesh_spec_for(n_devices)
    mesh = make_mesh(spec, devices=devices[:n_devices])
    sizes = spec.resolve(n_devices)
    n_heads = max(4, sizes[TP] * 2)
    seq = 8 * sizes[SP]
    n_micro = 2 * sizes[PP]
    batch = sizes[DP] * n_micro      # local batch per dp block == n_micro
    cfg = TransformerConfig(
        vocab_size=128, d_model=8 * n_heads, n_heads=n_heads,
        n_layers=2 * sizes[PP], d_ff=64, max_len=seq, causal=True,
        dtype=torch.float32, remat=True)

    def model_on(m, c):
        if m.shape.get(PP, 1) > 1:
            from ..models.pipeline import PipelinedTransformerLM
            return PipelinedTransformerLM(c, m, n_micro=n_micro,
                                          device=device)
        return TransformerLM(c, m, device=device)

    def tokens_of(seed, shape, vocab):
        gen = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, vocab, shape, generator=gen)
        return toks, torch.roll(toks, -1, dims=1)

    def tx():
        return T.adamw(T.warmup_cosine(1e-2, 2, 100), weight_decay=0.01)

    model = model_on(mesh, cfg)
    tokens, targets = tokens_of(1, (batch, seq), cfg.vocab_size)
    params = model.place(model.init(torch.Generator().manual_seed(0)))
    _, _, loss = model.build_train_step(tx())(
        params, model.init_opt(params, tx()), tokens, targets)
    loss = _finite(float(loss), "loss")

    # second leg: ZeRO-1 on the same mesh — with pp live, the pipelined
    # ZeRO-1 path (dp-split state with a pp row dimension)
    z1 = ""
    if sizes[DP] > 1:
        p1 = model.place(model.init(torch.Generator().manual_seed(0)))
        _, _, z1_loss = model.build_train_step(tx(), zero1=True)(
            p1, model.init_opt_zero1(p1, tx()), tokens, targets)
        z1_loss = _finite(float(z1_loss), "zero1 loss")
        kind = "pp-pipelined" if sizes[PP] > 1 else "plain"
        z1 = f" zero1[{kind},dp{sizes[DP]}]_loss={z1_loss:.4f}"

    # third leg: ring attention across ranks.  The round-robin factoring
    # gives sp=1 at n=8 (dp2·pp2·tp2): fold pp into sp (the same ranks)
    # so the ring runs at n=8 too
    sp = ""
    if sizes[SP] == 1 and sizes[PP] > 1:
        sp_spec = MeshSpec(dp=sizes[DP], sp=sizes[PP] * sizes[SP],
                           tp=sizes[TP], pp=1, ep=1)
        sp_mesh = make_mesh(sp_spec, devices=devices[:n_devices])
        sp_seq = 8 * sp_spec.sp
        sp_cfg = TransformerConfig(
            vocab_size=128, d_model=8 * n_heads, n_heads=n_heads,
            n_layers=2, d_ff=64, max_len=sp_seq, causal=True,
            dtype=torch.float32, remat=True)
        sp_model = TransformerLM(sp_cfg, sp_mesh, device=device)
        p2 = sp_model.place(sp_model.init(torch.Generator().manual_seed(0)))
        sp_tokens, sp_targets = tokens_of(2, (sizes[DP] * 2, sp_seq),
                                          sp_cfg.vocab_size)
        _, _, sp_loss = sp_model.build_train_step(tx())(
            p2, sp_model.init_opt(p2, tx()), sp_tokens, sp_targets)
        sp_loss = _finite(float(sp_loss), "sp loss")
        sp = (f" ring[dp{sp_spec.dp}·tp{sp_spec.tp}·sp{sp_spec.sp}]"
              f"_loss={sp_loss:.4f}")

    line = (f"dryrun_multichip OK: mesh={dict(sizes)} devices={n_devices} "
            f"batch={batch} seq={seq} "
            f"n_micro={n_micro if sizes[PP] > 1 else 0} "
            f"loss={loss:.4f}{z1}{sp}")
    if world_rank() == 0:
        print(line, flush=True)
    return line


#: seconds a spawned rank may take before the dryrun fails as hung (the
#: process groups' own wait for a peer)
DRYRUN_TIMEOUT_S = DEFAULT_TIMEOUT_S


def _rank_main(rank, world, store, device, conn) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        import torch

        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device).index or 0)
        from .mesh import initialize_multihost, shutdown_multihost

        initialize_multihost(f"file://{store}", world, rank, backend="gloo",
                             timeout_s=DRYRUN_TIMEOUT_S)
        try:
            conn.send(("ok", dryrun_multichip(world, device=device)))
        finally:
            shutdown_multihost()
    except Exception:        # the rank's boundary: reported to the parent
        conn.send(("err", f"rank {rank}:\n{traceback.format_exc()}"))


def run_dryrun(n_devices: int, device: str = "cuda",
               timeout_s: float = DRYRUN_TIMEOUT_S) -> str:
    """Spawn ``n_devices`` gloo ranks on ``device`` (all on one card for
    ``cuda``), run :func:`dryrun_multichip` in each, and return the OK
    line; any rank's failure, or a rank not done in ``timeout_s``, kills
    every rank and raises."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dl4j_dryrun_") as tmp:
        procs, conns = [], []
        for r in range(n_devices):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main,
                            args=(r, n_devices, str(Path(tmp) / "store"),
                                  str(device), child), daemon=True)
            p.start()
            procs.append(p)
            conns.append(parent)
        deadline = time.monotonic() + timeout_s
        lines, errors = [], []
        try:
            for r, c in enumerate(conns):
                if not c.poll(max(0.0, deadline - time.monotonic())):
                    errors.append(f"rank {r} not done in {timeout_s} s")
                    break
                try:
                    kind, value = c.recv()
                except EOFError:
                    kind, value = "err", f"rank {r} died"
                (errors if kind == "err" else lines).append(value)
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("dryrun failed:\n" + "\n".join(errors))
    return lines[0]
