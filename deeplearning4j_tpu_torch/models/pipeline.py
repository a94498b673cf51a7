"""Pipeline parallelism over the ``pp`` mesh axis: GPipe-style micro-batch
fill and drain.

Port of ``deeplearning4j_tpu/models/pipeline.py``, SPMD over ranks:

- The transformer blocks are **stacked on a leading layer axis** and that
  axis is split over ``pp``: each pp rank holds ``n_layers / pp``
  contiguous blocks (a *stage*) as one dict of ``(L_loc, ...)`` leaves.
- Every rank runs the same program: ``M + S - 1`` ticks, at each of which
  a rank applies its stage to its current activation and hands the
  result to the next rank by ``ppermute``.  Rank 0 feeds micro-batch
  ``t`` in; the last rank collects the finished micro-batches from tick
  ``S - 1`` on.
- **The backward needs no schedule of its own**: ``ppermute``'s backward
  is the inverse rotation, so autograd runs the drain-ordered backward
  pipeline.  It does so in one order on every rank because every rank
  builds the same graph: where ranks differ (the first feeds, the last
  scores, the fill/drain ticks are bubbles) the code selects with tensor
  masks, never a Python branch on the rank, as the reference's
  ``jnp.where`` does.
- Embedding, final LN and head are replicated over ``pp`` but *used* only
  on the first or last rank; their local gradients are partial
  contributions (zero on the unused ranks), so the pp gradient sync is a
  ``psum`` — unlike dp/sp, whose replicas hold whole per-shard gradients
  and average them.

It composes with the other axes in the same mesh: dp (batch blocks and a
gradient mean), sp (ring attention inside each block) and tp (the
Megatron boundaries inside each block).  The bubble fraction is
``(S-1)/(M+S-1)``: pick ``n_micro >= 2*S``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import DP, PP, SP, TP, P, _dim_axes
from ..utils.tree_math import tree_leaves, tree_unflatten
from .transformer import (
    TransformerConfig,
    TransformerLM,
    _block,
    _layernorm,
    _lm_head,
    _names,
    _reduce_leaves,
    embed_local,
    lm_head_loss,
    param_specs,
)


# --------------------------------------------------------------------- layout

def stack_layers(params):
    """List-of-layer-dicts -> one stacked dict with a leading layer axis
    (the axis ``pp`` splits).  Non-layer leaves pass through."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    out["layers"] = {k: torch.stack([lp[k] for lp in layers])
                     for k in layers[0]}
    return out


def unstack_layers(params, n_layers: int):
    """Inverse of :func:`stack_layers` (checkpoint interchange with the
    list-layout ``TransformerLM``)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    st = params["layers"]
    out["layers"] = [{k: v[i] for k, v in st.items()}
                     for i in range(n_layers)]
    return out


def pipeline_param_specs(cfg: TransformerConfig):
    """Stacked-layout PartitionSpecs: the stacked layer axis is split over
    pp; inner axes keep their tp split; everything else replicated."""
    base = param_specs(cfg)
    specs = {k: v for k, v in base.items() if k != "layers"}
    specs["layers"] = {k: P(PP, *s) for k, s in base["layers"][0].items()}
    return specs


# ------------------------------------------------------------------ schedule

def _stage_masks(n_pp: int, device):
    """This rank's pp coordinate as device tensors: (is first, is last,
    the coordinate)."""
    from ..parallel import collectives as clv

    stage = torch.tensor(clv.axis_index(PP), device=device)
    return stage == 0, stage == n_pp - 1, stage


def pipelined_encode_local(params, tokens, cfg: TransformerConfig, *,
                           n_pp: int, n_micro: int, n_sp: int = 1,
                           sp_axis=None, tp_axis=None):
    """Final hidden states for the local (dp/sp block) tokens, the layer
    stack run as an ``n_pp``-stage, ``n_micro``-micro-batch pipeline.
    Every rank returns a tensor of the same shape; only the LAST rank's is
    the sequence's encoding (callers mask with the pp coordinate)."""
    from ..parallel import collectives as clv

    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"local batch {B} % n_micro {n_micro}")
    first, _, stage = _stage_masks(n_pp, tokens.device)

    # the embedding on every rank (one program; a gather), read by rank 0
    x = embed_local(params, tokens, cfg, sp_axis)
    micro = x.reshape(n_micro, B // n_micro, T, x.shape[-1])
    stacked = params["layers"]                    # (L_loc, ...) leaves
    n_loc = next(iter(stacked.values())).shape[0]
    remat = cfg.remat and torch.is_grad_enabled()

    def apply_stage(h):
        for i in range(n_loc):
            lp = {k: v[i] for k, v in stacked.items()}
            if remat:
                h = checkpoint(_block, lp, h, cfg, n_sp, sp_axis, tp_axis, T,
                               use_reentrant=False)
            else:
                h = _block(lp, h, cfg, n_sp, sp_axis, tp_axis, T)
        return h

    n_ticks = n_micro + n_pp - 1
    right = [(i, (i + 1) % n_pp) for i in range(n_pp)]
    recv = torch.zeros_like(micro[0])
    outs = [None] * n_micro
    for t in range(n_ticks):
        xin = torch.where(first, micro[min(t, n_micro - 1)], recv)
        # zero the bubble lane (fill/drain ticks) BEFORE the stage runs: a
        # masked-out lane that went non-finite would poison the real
        # gradients through the mask's backward (0 * inf = nan)
        valid = (t >= stage) & (t < n_micro + stage)
        xin = torch.where(valid, xin, torch.zeros_like(xin))
        y = apply_stage(xin)
        if t >= n_pp - 1:
            outs[t - (n_pp - 1)] = y
        if t < n_ticks - 1:
            # the last tick's hand-off is never read: no last send
            recv = clv.ppermute(y, PP, right)
    h = torch.stack(outs).reshape(B, T, x.shape[-1])
    return _layernorm(h, params["final_ln_scale"], params["final_ln_bias"])


def _last_only(loss, n_pp: int):
    _, last, _ = _stage_masks(n_pp, loss.device)
    return torch.where(last, loss, torch.zeros_like(loss))


def pipelined_lm_loss_local(params, tokens, targets, cfg: TransformerConfig,
                            *, n_pp: int, n_micro: int, **axes):
    """Local masked LM loss: real on the last pp rank, 0 elsewhere; the
    caller psums over pp (exactly one rank contributes), then averages
    over dp/sp."""
    h = pipelined_encode_local(params, tokens, cfg, n_pp=n_pp,
                               n_micro=n_micro, **axes)
    return _last_only(lm_head_loss(params, h, targets, cfg), n_pp)


def pipelined_cls_loss_local(backbone, head, tokens, labels,
                             cfg: TransformerConfig, *, n_pp: int,
                             n_micro: int, n_sp: int = 1, sp_axis=None,
                             tp_axis=None):
    """Classifier fine-tune loss through the pipeline: mean-pool the last
    rank's encoding (a pmean over sp), dense head, cross entropy — real on
    the last pp rank, 0 elsewhere (the caller psums over pp)."""
    h = pipelined_encode_local(backbone, tokens, cfg, n_pp=n_pp,
                               n_micro=n_micro, n_sp=n_sp, sp_axis=sp_axis,
                               tp_axis=tp_axis)
    pooled = h.float().mean(dim=1)
    if sp_axis:
        from ..parallel import collectives as clv

        pooled = clv.pmean(pooled, sp_axis)
    logits = pooled @ head["w_cls"].float() + head["b_cls"]
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels.long()[:, None]).mean()
    return _last_only(loss, n_pp)


# --------------------------------------------------------------------- facade

class PipelinedTransformerLM(TransformerLM):
    """The flagship trainer with the pp axis live: (pp, dp, sp, tp) SPMD
    over ranks.  The parameter layout is the STACKED one (use
    :func:`stack_layers` / :func:`unstack_layers` to interchange with
    ``TransformerLM``)."""

    def __init__(self, cfg: TransformerConfig, mesh,
                 n_micro: int | None = None, *, device=None):
        super().__init__(cfg, mesh, device=device)
        self.n_pp = mesh.shape.get(PP, 1)
        if self.n_pp <= 1:
            raise ValueError("use TransformerLM when pp == 1")
        if cfg.n_layers % self.n_pp:
            raise ValueError(f"n_layers {cfg.n_layers} % pp {self.n_pp}")
        self.n_micro = n_micro if n_micro is not None else 2 * self.n_pp

    def init(self, gen: torch.Generator | None = None) -> dict:
        return stack_layers(super().init(gen))

    def _unstacked_only(name):
        def guard(self, *a, **kw):
            raise NotImplementedError(
                f"{name} runs on the unstacked single-device layout: "
                f"TransformerLM(cfg).{name}(unstack_layers("
                "model.gather(params), cfg.n_layers), ...)")
        guard.__name__ = name
        return guard

    sample = _unstacked_only("sample")
    beam_search = _unstacked_only("beam_search")
    score = _unstacked_only("score")
    del _unstacked_only

    def _specs(self):
        return pipeline_param_specs(self.cfg)

    def _grad_sync(self, specs, sp_axis, tp_axis, include_dp: bool = True):
        """dp/sp replicas hold whole per-block gradients (a mean); pp holds
        PARTIAL contributions on the pp-replicated leaves (a psum), while
        the stage-split leaves have their whole gradient here.
        ``include_dp=False`` is the ZeRO-1 path."""
        base = super()._grad_sync(specs, sp_axis, tp_axis, include_dp)

        def sync(grads):
            return _reduce_leaves(base(grads), specs, PP, False,
                                  lambda sp: not _names(sp, PP))

        return sync

    def _loss_reduce(self, loss, sp_axis):
        """Exactly one pp rank (the last) holds the real loss: a psum over
        pp recovers it, then the dp/sp mean."""
        from ..parallel import collectives as clv

        return super()._loss_reduce(clv.psum(loss, PP), sp_axis)

    # -- ZeRO-1 over dp, composed with pp -------------------------------
    #
    # Stage-split leaves (the stacked ``layers``, spec ``P(PP, ...)``)
    # hold a DIFFERENT block per pp rank, as tp-split leaves do per tp
    # rank, so their dp-split state grows a pp row dimension: globally
    # ``(rows, n_dp * k)`` with ``rows = n_pp·[n_tp]`` and spec
    # ``P((PP[, TP]), DP)``.  Every rank still holds a ``(1, k)`` leaf, so
    # the parent's scatter / update / gather step is unchanged.

    def _decay_mask(self, tree):
        """Stacking grafts a leading layer axis onto every per-layer leaf,
        so the ndim >= 2 weight-class default misfires there (a (D,) LN
        scale becomes (L, D)): a stacked leaf is weight-class iff its
        unstacked form is, i.e. ndim >= 3."""
        def mask(node, stacked=False):
            if isinstance(node, dict):
                return {k: mask(v, stacked or k == "layers")
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(mask(v, stacked) for v in node)
            return node.dim() >= (3 if stacked else 2)

        return mask(tree)

    def _z1_leaf_is_pp_sharded(self, spec) -> bool:
        return _names(spec, PP)

    def _z1_row_layout(self, spec):
        """(row count, the rows' spec entry) of a leaf's ZeRO-1 state."""
        n_tp = self._axes()[2]
        axes = []
        if self._z1_leaf_is_pp_sharded(spec):
            axes.append((PP, self.n_pp))
        if self._z1_leaf_is_tp_sharded(spec) and n_tp > 1:
            axes.append((TP, n_tp))
        names = tuple(a for a, _ in axes)
        row_spec = names if len(names) > 1 else (names[0] if names else None)
        rows = 1
        for _, n in axes:
            rows *= n
        return rows, row_spec

    def build_train_step(self, tx=None, lr: float = 1e-3, zero1: bool = False):
        """``step(params, opt, tokens, targets) -> (params, opt, loss)``
        with the layer stack pipelined over pp (the parent's step; only
        the loss, the specs and the reductions differ).  ``zero1=True``
        shards the optimizer state over dp, the stage-split leaves
        included (pair with ``init_opt_zero1``)."""
        cfg = self.cfg
        tx = tx if tx is not None else self._default_tx(lr)
        n_pp, n_micro = self.n_pp, self.n_micro

        def loss_of(params, tokens, targets, axes):
            return pipelined_lm_loss_local(params, tokens, targets, cfg,
                                           n_pp=n_pp, n_micro=n_micro, **axes)

        return self._build_step(tx, loss_of, self._specs(),
                                (P(DP, SP), P(DP, SP)), zero1=zero1)

    def _pipeline_axes(self):
        s = self.mesh.shape
        n_sp, n_tp = s.get(SP, 1), s.get(TP, 1)
        return dict(n_sp=n_sp, sp_axis=SP if n_sp > 1 else None,
                    tp_axis=TP if n_tp > 1 else None)

    def forward(self, params, tokens):
        """Vocabulary logits (B, T, V) of the GLOBAL batch through the
        pipeline, on every rank: the last pp rank's logits of its block,
        replicated by a psum of the masked value over pp, then gathered
        over dp and sp."""
        from ..parallel import collectives as clv
        from ..parallel.mesh import NamedSharding, global_block, local_block

        cfg, mesh = self.cfg, self.mesh
        blocks = NamedSharding(mesh, P(DP, SP))
        with torch.no_grad(), mesh:
            toks = local_block(self._to_device(tokens), blocks)
            h = pipelined_encode_local(params, toks, cfg, n_pp=self.n_pp,
                                       n_micro=self.n_micro,
                                       **self._pipeline_axes())
            logits = torch.einsum("btd,dv->btv", h.to(cfg.dtype),
                                  _lm_head(params, cfg).to(cfg.dtype)).float()
            logits = clv.psum(_last_only(logits, self.n_pp), PP)
        return global_block(logits, blocks)

    def build_finetune_step(self, tx=None, lr: float = 2e-5):
        """Classifier fine-tune step with the layer stack pipelined over
        pp."""
        cfg = self.cfg
        tx = tx if tx is not None else self._default_tx(lr)
        n_pp, n_micro = self.n_pp, self.n_micro

        def loss_of(tree, tokens, labels, axes):
            return pipelined_cls_loss_local(
                tree["backbone"], tree["head"], tokens, labels, cfg,
                n_pp=n_pp, n_micro=n_micro, **axes)

        return self._build_step(tx, loss_of, self.finetune_specs(),
                                (P(DP, SP), P(DP)))


def zero1_state_to_natural(model: TransformerLM, tx, opt_global, params):
    """A GLOBAL ZeRO-1 optimizer state of ``model`` (the on-disk layout,
    ``model.gather(opt, model.opt_specs_zero1(tx))``: every state leaf
    ``(rows, n_dp * k)``) as the natural state of the GLOBAL ``params``:
    each row's chunk trimmed, reshaped to its block, and the blocks put
    back where ``model``'s specs place them — the state a one-device
    model continues from (after :func:`unstack_layers` for a pipelined
    one).  Leaves that are not per-parameter (step counts) pass
    through."""
    count, st = opt_global
    p_leaves = tree_leaves(params)
    p_specs = tree_leaves(model._specs())
    # marker specs, never placed: state_spec echoes each one back beside
    # the state leaves of its parameter
    # graftlint: disable=SH02
    marks = tree_unflatten(params, [P(("param", i))
                                    for i in range(len(p_leaves))])
    s_specs = tree_leaves(tx.state_spec(marks) if tx.state_spec else ())
    s_leaves = tree_leaves(st)
    if len(s_specs) != len(s_leaves):
        raise ValueError(f"state_spec gives {len(s_specs)} specs for "
                         f"{len(s_leaves)} state leaves")
    out = []
    for leaf, mark in zip(s_leaves, s_specs):
        tag = mark.axes[0] if len(mark) else None
        if torch.is_tensor(leaf) and isinstance(tag, tuple) \
                and tag[0] == "param":
            i = tag[1]
            leaf = _unchunk(leaf, p_leaves[i], p_specs[i], model)
        out.append(leaf)
    return count, tree_unflatten(st, out)


def _unchunk(state, param, spec, model):
    """One ZeRO-1 state leaf ``(rows, n_dp * k)`` as a natural tensor of
    ``param``'s global shape: row r holds the padded flat block of the
    rank whose row coordinates (first row axis major) are r's digits."""
    rows, row_spec = model._z1_row_layout(spec)
    axes = _dim_axes(row_spec)
    mesh = model.mesh
    block = list(param.shape)
    for dim, entry in enumerate(spec):
        for a in _dim_axes(entry):
            if a in axes:
                block[dim] //= mesh.axis_size(a)
    size = 1
    for b in block:
        size *= b
    out = torch.empty(tuple(param.shape), dtype=state.dtype,
                      device=state.device)
    for r in range(rows):
        coords, rem = {}, r
        for a in reversed(axes):
            coords[a] = rem % mesh.axis_size(a)
            rem //= mesh.axis_size(a)
        index = []
        for dim, entry in enumerate(spec):
            named = [a for a in _dim_axes(entry) if a in axes]
            i = 0
            for a in named:
                i = i * mesh.axis_size(a) + coords[a]
            index.append(slice(i * block[dim], (i + 1) * block[dim])
                         if named else slice(None))
        out[tuple(index)] = state[r, :size].reshape(block)
    return out
