"""RNTN — Recursive Neural Tensor Network over binary parse trees.

Port of ``deeplearning4j_tpu/models/rntn.py`` (capability match of
``models/rntn/RNTN.java:54,340,703``): leaf word vectors composed bottom-up
with a bilinear tensor + affine layer, per-node softmax classification
(sentiment-style), trained over a tree corpus.

Each tree becomes fixed-size post-order arrays (child slots, word ids,
labels, mask) padded to a node budget (:func:`linearize`, the
reference's, byte for byte).  A batch of trees is composed together: one
loop over the node slots fills a ``(B, N, d)`` buffer, gathering each
tree's two children by slot, adding the bilinear term
``einsum("dij,bi,bj->bd")`` to the affine term ``[c, 1] @ W^T`` under
``tanh`` (as two products and an ``addmm``), and selecting leaf or
internal rows with ``where``.  The buffer
is written out of place (``index_copy``), so autograd sees every slot.
Parameters keep the reference's names and layouts (``emb (V,d)``,
``W (d,2d+1)``, ``V (d,2d,2d)``, ``Ws (C,d)``, ``bs (C,)``), so
``models.convert.params_from_numpy`` carries a reference model's tree
across unchanged.  ``init`` draws from a ``torch.Generator`` on the
model's device seeded ``seed``.  A training step is autograd through the
slot loop and AdaGrad (``p - lr g rsqrt(h + 1e-8)``); ``fit`` reads one
loss a batch to the host, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..text.tree import Tree
from ..text.vocab import VocabCache

UNK = "*UNK*"

_FIELDS = ("is_leaf", "word", "left", "right", "label", "mask")
#: trees a forward pass in ``accuracy``
_CHUNK = 256


@dataclasses.dataclass
class TreeArrays:
    """Post-order linearization; index -1 (masked) slots are padding."""

    is_leaf: np.ndarray      # (N,) int32 1/0
    word: np.ndarray         # (N,) int32 vocab id (leaves)
    left: np.ndarray         # (N,) int32 child slot (internal)
    right: np.ndarray        # (N,) int32
    label: np.ndarray        # (N,) int32 gold class (-1 = none)
    mask: np.ndarray         # (N,) float32 1 for real node

    @property
    def n_slots(self) -> int:
        return self.is_leaf.shape[0]


def linearize(tree: Tree, vocab: VocabCache, max_nodes: int) -> TreeArrays | None:
    """Post-order arrays; None if the tree exceeds the node budget."""
    nodes = []

    def visit(t: Tree) -> int:
        # collapse unary chains (incl. pre-terminals (tag (word))) downward
        while len(t.children) == 1:
            child = t.children[0]
            if child.gold_label < 0:
                child.gold_label = t.gold_label
            t = child
        if t.is_leaf():
            nodes.append(("leaf", t))
            return len(nodes) - 1
        assert len(t.children) == 2, "RNTN needs binary trees (use binarize())"
        l = visit(t.children[0])
        r = visit(t.children[1])
        nodes.append(("internal", t, l, r))
        return len(nodes) - 1

    visit(tree)
    n = len(nodes)
    if n > max_nodes:
        return None
    arrs = TreeArrays(
        is_leaf=np.zeros(max_nodes, np.int32),
        word=np.zeros(max_nodes, np.int32),
        left=np.zeros(max_nodes, np.int32),
        right=np.zeros(max_nodes, np.int32),
        label=np.full(max_nodes, -1, np.int32),
        mask=np.zeros(max_nodes, np.float32),
    )
    for i, rec in enumerate(nodes):
        arrs.mask[i] = 1.0
        node = rec[1]
        arrs.label[i] = node.gold_label
        if rec[0] == "leaf":
            arrs.is_leaf[i] = 1
            idx = vocab.index_of(node.word.lower() if node.word else "")
            arrs.word[i] = idx if idx >= 0 else vocab.index_of(UNK)
        else:
            arrs.left[i], arrs.right[i] = rec[2], rec[3]
    return arrs


def _forward_trees(params, t) -> torch.Tensor:
    """The ``(B, N, d)`` vector buffer of a batch of linearized trees: one
    pass over the post-order slots, every tree at once.  A slot's
    children are gathered together as ``c = [a, b]``; the bilinear term
    ``einsum("dij,bi,bj->bd", V, c, c)`` is ``(c @ Vm).view(B, d, 2d) @ c``
    with ``Vm[i, (k, j)] = V[k, i, j]``, and the affine term ``[c, 1] @
    W^T`` one ``addmm`` (fewer launches a slot, the same sums)."""
    emb, W, V = params["emb"], params["W"], params["V"]
    B, N = t["is_leaf"].shape
    d = emb.shape[1]
    rows = torch.arange(B, device=emb.device)[:, None]
    slots = torch.arange(N, device=emb.device)
    # per-slot views split once: a slice a slot would cost its backward a
    # zero-filled (B, N, d) gradient each
    kids = torch.stack([t["left"], t["right"]], dim=2).unbind(1)  # (B, 2)
    leaf = (t["is_leaf"] == 1)[..., None].unbind(1)               # (B, 1)
    leaf_vecs = emb[t["word"]].unbind(1)                          # (B, d)
    Vm = V.permute(1, 0, 2).reshape(2 * d, d * 2 * d)
    Wc, wb = W[:, :2 * d].T, W[:, 2 * d]
    buf = emb.new_zeros((B, N, d))
    for i in range(N):
        c = buf[rows, kids[i]].reshape(B, 2 * d)                  # (B, 2d)
        bilinear = torch.bmm((c @ Vm).view(B, d, 2 * d), c[:, :, None])
        pre = torch.addmm(wb, c, Wc) + bilinear[..., 0]
        vec = torch.where(leaf[i], leaf_vecs[i], torch.tanh(pre))
        buf = buf.index_copy(1, slots[i:i + 1], vec[:, None])
    return buf


def _logits(params, buf) -> torch.Tensor:
    return buf @ params["Ws"].T + params["bs"]              # (B, N, C)


def _batch_loss(params, batch, l2: float) -> torch.Tensor:
    """Per-node log-softmax loss over the labelled real nodes, divided by
    their count, plus ``l2 / 2`` times the squares of every parameter
    but ``bs``."""
    logp = torch.log_softmax(_logits(params, _forward_trees(params, batch)),
                             dim=-1)
    labels = batch["label"]
    has_label = (labels >= 0) & (batch["mask"] > 0)
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    count = has_label.sum().to(logp.dtype)
    data = -torch.where(has_label, ll, 0.0).sum() / torch.clamp(count, min=1.0)
    reg = sum((p * p).sum() for n, p in params.items() if n != "bs")
    return data + 0.5 * l2 * reg


def _loss_and_grads(params, batch, l2: float):
    """The batch loss and its gradient for every parameter (a dict)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = _batch_loss(leaves, batch, l2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


class RNTN:
    def __init__(self, *, layer_size: int = 25, n_classes: int = 5,
                 max_nodes: int = 64, lr: float = 0.05, l2: float = 1e-4,
                 adagrad: bool = True, seed: int = 0, device=None):
        self.d = layer_size
        self.n_classes = n_classes
        self.max_nodes = max_nodes
        self.lr = lr
        self.l2 = l2
        self.adagrad = adagrad
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab = VocabCache()
        self.params = None
        self._hist = None
        self._step = None

    # ------------------------------------------------------------------ setup
    def build_vocab(self, trees: Iterable[Tree]) -> None:
        for tree in trees:
            for w in tree.words():
                self.vocab.add(w.lower())
        self.vocab.add(UNK)
        self.vocab.finalize_indices()

    def init(self):
        d, v = self.d, len(self.vocab)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=self.device)

        self.params = {
            "emb": 0.1 * normal(v, d),
            "W": 0.01 * normal(d, 2 * d + 1),
            "V": 0.01 * normal(d, 2 * d, 2 * d),
            "Ws": 0.01 * normal(self.n_classes, d),
            "bs": torch.zeros((self.n_classes,), device=self.device),
        }
        self._hist = {k: torch.zeros_like(p) for k, p in self.params.items()}
        return self.params

    def _batch_arrays(self, trees: Sequence[Tree]):
        arrs = [linearize(t, self.vocab, self.max_nodes) for t in trees]
        arrs = [a for a in arrs if a is not None]
        if not arrs:
            return None
        return self._to_device(arrs)

    def _to_device(self, arrs: Sequence[TreeArrays]) -> dict:
        """Stacked arrays on the model's device; index fields as int64."""
        out = {}
        for k in _FIELDS:
            a = np.stack([getattr(x, k) for x in arrs])
            out[k] = torch.from_numpy(
                a if k == "mask" else a.astype(np.int64)).to(self.device)
        return out

    # ------------------------------------------------------------------ train
    def _build_step(self):
        l2, lr, adagrad = self.l2, self.lr, self.adagrad

        def step(params, hist, batch):
            loss, g = _loss_and_grads(params, batch, l2)
            with torch.no_grad():
                if adagrad:
                    hist = {k: h + g[k] * g[k] for k, h in hist.items()}
                    params = {k: p - lr * g[k] * torch.rsqrt(hist[k] + 1e-8)
                              for k, p in params.items()}
                else:
                    params = {k: p - lr * g[k] for k, p in params.items()}
            return params, hist, loss

        return step

    def fit(self, trees: Sequence[Tree], epochs: int = 20,
            batch_size: int = 32) -> list[float]:
        if len(self.vocab) == 0:
            self.build_vocab(trees)
        if self.params is None:
            self.init()
        if self._step is None:
            self._step = self._build_step()
        rng = np.random.default_rng(self.seed)
        per_epoch = []   # the batches' device losses, read once below
        for ep in range(epochs):
            order = rng.permutation(len(trees))
            batch_losses = []
            for off in range(0, len(trees), batch_size):
                batch_trees = [trees[i] for i in order[off:off + batch_size]]
                batch = self._batch_arrays(batch_trees)
                if batch is None:
                    continue
                self.params, self._hist, loss = self._step(
                    self.params, self._hist, batch)
                batch_losses.append(loss)
            per_epoch.append(batch_losses)
        losses = []
        for batch_losses in per_epoch:
            # the host floats summed in batch order, as a read per batch
            ep_loss = 0.0
            for v in (torch.stack(batch_losses).tolist()
                      if batch_losses else []):
                ep_loss += v
            losses.append(ep_loss / max(1, len(batch_losses)))
        return losses

    # ------------------------------------------------------------------ predict
    def _predict(self, arrs: Sequence[TreeArrays]) -> np.ndarray:
        """Per-slot predicted classes of linearized trees, ``(B, N)``."""
        with torch.no_grad():
            t = self._to_device(arrs)
            logits = _logits(self.params, _forward_trees(self.params, t))
            return logits.argmax(dim=-1).cpu().numpy()

    def _linearize_or_raise(self, tree: Tree) -> TreeArrays:
        arrs = linearize(tree, self.vocab, self.max_nodes)
        if arrs is None:
            raise ValueError(f"tree exceeds node budget {self.max_nodes}")
        return arrs

    def predict_tree(self, tree: Tree) -> np.ndarray:
        """Per-node predicted classes in post-order (root last)."""
        arrs = self._linearize_or_raise(tree)
        n_real = int(arrs.mask.sum())
        return self._predict([arrs])[0, :n_real]

    def predict_root(self, tree: Tree) -> int:
        return int(self.predict_tree(tree)[-1])

    def accuracy(self, trees: Sequence[Tree]) -> float:
        """Root accuracy over the trees with a gold label, ``_CHUNK`` trees
        a forward pass."""
        labelled = [t for t in trees if t.gold_label >= 0]
        good = 0
        for off in range(0, len(labelled), _CHUNK):
            part = labelled[off:off + _CHUNK]
            arrs = [self._linearize_or_raise(t) for t in part]
            preds = self._predict(arrs)
            roots = [int(a.mask.sum()) - 1 for a in arrs]
            good += sum(int(preds[j, r] == t.gold_label)
                        for j, (r, t) in enumerate(zip(roots, part)))
        return good / max(1, len(labelled))
