"""ResNet — the second model family the benchmark trains (ResNet-50,
ImageNet shapes).

Port of ``deeplearning4j_tpu/models/resnet.py``.  The API and the
parameter tree are the reference's: NHWC images, HWIO kernels, the tree
``{"stem", "stages"[s][b], "head"}`` and its running-stats twin, so a
reference tree moves across through numpy (``models.convert``) as it
is.  Inside, the model computes in ``torch.channels_last``: the NHWC
images permuted to NCHW are already a channels-last view, kernels are
permuted HWIO -> OIHW (and laid out channels-last) where they are used,
and padding and pooling keep the layout, so no NCHW <-> NHWC transpose
sits on the activations.

Numerics follow the reference: convolutions in ``cfg.dtype`` (bf16 by
default) over f32 parameters, BatchNorm statistics and the normalize in
f32 (``_bn``; ``bn_fold`` folds them into one per-channel affine in the
compute dtype), the head in f32.  Padding is XLA's SAME, computed by
``ops.convolution.same_pads`` (a 3x3 stride-2 convolution on an even
input pads (0, 1), which ``F.conv2d(padding=1)`` would not); the max pool
pads with -inf.  A float32 convolution runs under
``ops.convolution.exact_f32`` (cuDNN's TF32 off), its backward too.
The convolutions are cuDNN's: the reference's are XLA convolutions, not
kernels of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.convolution import exact_f32, max_pool, same_pads


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    bn_fold: bool = False  # apply BN as a folded per-channel affine in the
    #                        compute dtype (stats still f32)
    stem_space_to_depth: bool = True  # the 7x7/2 stem conv as the exactly
    #                                   equivalent 4x4/1 conv on a 2x2
    #                                   space-to-depth input

    @classmethod
    def resnet18(cls, num_classes=1000, **kw):
        return cls(num_classes=num_classes, stage_sizes=(2, 2, 2, 2), **kw)

    @classmethod
    def resnet50(cls, num_classes=1000, **kw):
        return cls(num_classes=num_classes, stage_sizes=(3, 4, 6, 3), **kw)

    def flops_per_image(self, image_size: int = 224) -> float:
        """Analytic training FLOPs per image (2*MACs forward, x3 for
        fwd+bwd), counting convs + the classifier matmul (the reference's
        count, used for MFU)."""
        def conv_flops(hw, k, cin, cout, stride):
            out_hw = hw // stride
            return 2.0 * out_hw * out_hw * k * k * cin * cout, out_hw

        total, hw = 0.0, image_size
        f, hw = conv_flops(hw, 7, 3, self.width, 2)          # stem
        total += f
        hw //= 2                                             # 3x3/2 max pool
        c_in = self.width
        for s, blocks in enumerate(self.stage_sizes):
            c_mid = self.width * (2 ** s)
            c_out = c_mid * 4
            for b in range(blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                f1, _ = conv_flops(hw, 1, c_in, c_mid, 1)
                f2, hw2 = conv_flops(hw, 3, c_mid, c_mid, stride)
                f3, _ = conv_flops(hw2, 1, c_mid, c_out, 1)
                total += f1 + f2 + f3
                if c_in != c_out or stride != 1:
                    fp, _ = conv_flops(hw, 1, c_in, c_out, stride)
                    total += fp
                hw = hw2
                c_in = c_out
        total += 2.0 * c_in * self.num_classes               # head matmul
        return 3.0 * total                                   # fwd + bwd


# --------------------------------------------------------------------------- init

def _blocks(cfg: ResNetConfig):
    """(stage, block, c_in, c_mid, c_out, stride, has_proj) in order."""
    c_in = cfg.width
    for s, blocks in enumerate(cfg.stage_sizes):
        c_mid = cfg.width * (2 ** s)
        c_out = c_mid * 4
        for b in range(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            yield s, b, c_in, c_mid, c_out, stride, (c_in != c_out
                                                     or stride != 1)
            c_in = c_out


def init_params(gen: torch.Generator, cfg: ResNetConfig, device=None) -> dict:
    """He-normal kernels (HWIO) drawn from ``gen`` on its device, BN scale
    1 and bias 0, the head scaled by sqrt(1/fan_in); the tree lands on
    ``device``.  (torch and jax give different numbers from one seed:
    parity with the JAX package goes through ``models.convert``.)"""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w * std).to(device=dev, dtype=pd)

    def conv(shape):
        return normal(shape, float(np.sqrt(2.0 / (shape[0] * shape[1]
                                                  * shape[2]))))

    def bn(c):
        return {"scale": torch.ones((c,), dtype=pd, device=dev),
                "bias": torch.zeros((c,), dtype=pd, device=dev)}

    params: dict = {"stem": {"conv": conv((7, 7, 3, cfg.width)),
                             "bn": bn(cfg.width)},
                    "stages": [[] for _ in cfg.stage_sizes]}
    c_last = cfg.width
    for s, _, c_in, c_mid, c_out, _, proj in _blocks(cfg):
        blk = {"conv1": conv((1, 1, c_in, c_mid)), "bn1": bn(c_mid),
               "conv2": conv((3, 3, c_mid, c_mid)), "bn2": bn(c_mid),
               "conv3": conv((1, 1, c_mid, c_out)), "bn3": bn(c_out)}
        if proj:
            blk["proj"] = conv((1, 1, c_in, c_out))
            blk["proj_bn"] = bn(c_out)
        params["stages"][s].append(blk)
        c_last = c_out
    params["head"] = {
        "w": normal((c_last, cfg.num_classes), float(np.sqrt(1.0 / c_last))),
        "b": torch.zeros((cfg.num_classes,), dtype=pd, device=dev)}
    return params


def init_batch_stats(cfg: ResNetConfig, device=None) -> dict:
    """Running-stats tree mirroring the BN nodes of :func:`init_params`
    (a separate collection: params stay a pure gradient target; stats
    thread through train steps as data)."""
    dev = resolve_device(device)

    def node(c):
        return {"mean": torch.zeros((c,), dtype=torch.float32, device=dev),
                "var": torch.ones((c,), dtype=torch.float32, device=dev)}

    stats: dict = {"stem": {"bn": node(cfg.width)},
                   "stages": [[] for _ in cfg.stage_sizes]}
    for s, _, _, c_mid, c_out, _, proj in _blocks(cfg):
        blk = {"bn1": node(c_mid), "bn2": node(c_mid), "bn3": node(c_out)}
        if proj:
            blk["proj_bn"] = node(c_out)
        stats["stages"][s].append(blk)
    return stats


# --------------------------------------------------------------------------- layers

def _kernel(w, dtype):
    """An HWIO kernel as the OIHW, channels-last tensor cuDNN takes."""
    return w.permute(3, 2, 0, 1).to(dtype, memory_format=torch.channels_last)


def _conv_oihw(x, w, stride, dtype):
    """SAME cross-correlation of a channels-last NCHW ``x`` with an OIHW
    kernel, XLA's padding: symmetric pads go to the convolution, an
    asymmetric one (stride 2 on an even size) is padded explicitly."""
    kh, kw = w.shape[-2:]
    ph = same_pads(x.shape[-2], kh, stride)
    pw = same_pads(x.shape[-1], kw, stride)
    x = x.to(dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        pad = (0, 0)
    with exact_f32():
        return F.conv2d(x, w, stride=stride, padding=pad)


def _conv(x, w, stride=1, dtype=torch.bfloat16):
    return _conv_oihw(x, _kernel(w, dtype), stride, dtype)


def _per_channel(v):
    return v[None, :, None, None]


def _bn(x, p, rs=None, train=True, momentum=0.9, eps=1e-5, fold=False):
    """BatchNorm over (N, H, W) of a channels-last NCHW ``x``, statistics
    in f32.  ``rs`` = running stats ``{"mean", "var"}``: train mode
    normalizes with the batch's (population) moments and, when ``rs`` is
    given, returns the EMA-updated stats from the detached moments; eval
    mode normalizes with ``rs``.  ``fold=False`` normalizes in f32 and
    casts back; ``fold=True`` folds (mean, var, scale, bias) into one
    per-channel affine applied in the input dtype.  Returns ``(y,
    new_rs)``; ``new_rs`` is None when stats aren't threaded.  A float64
    ``x`` keeps its statistics in float64 (the tests' exact run)."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if train:
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
        new_rs = None
        if rs is not None:
            m, v = mean.detach(), var.detach()
            new_rs = {"mean": momentum * rs["mean"] + (1 - momentum) * m,
                      "var": momentum * rs["var"] + (1 - momentum) * v}
    else:
        if rs is None:
            raise ValueError("eval-mode BN needs running stats "
                             "(init_batch_stats + a training pass)")
        mean, var, new_rs = rs["mean"], rs["var"], rs
    inv = torch.rsqrt(var + eps)
    if fold:
        sc = (p["scale"] * inv).to(x.dtype)
        bi = (p["bias"] - p["scale"] * mean * inv).to(x.dtype)
        return x * _per_channel(sc) + _per_channel(bi), new_rs
    y = (x32 - _per_channel(mean)) * _per_channel(inv)
    return (y * _per_channel(p["scale"])
            + _per_channel(p["bias"])).to(x.dtype), new_rs


def _bottleneck(x, blk, stride, dtype, rs=None, train=True, momentum=0.9,
                fold=False):
    new_rs = {} if rs is not None else None

    def bn(name, h):
        y, n = _bn(h, blk[name], None if rs is None else rs[name], train,
                   momentum, fold=fold)
        if new_rs is not None:
            new_rs[name] = n
        return y

    h = torch.relu(bn("bn1", _conv(x, blk["conv1"], 1, dtype)))
    h = torch.relu(bn("bn2", _conv(h, blk["conv2"], stride, dtype)))
    h = bn("bn3", _conv(h, blk["conv3"], 1, dtype))
    if "proj" in blk:
        x = bn("proj_bn", _conv(x, blk["proj"], stride, dtype))
    return torch.relu(x + h), new_rs


def _space_to_depth(x):
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel-minor order (a, b, c)."""
    N, H, W, C = x.shape
    x = x.reshape(N, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(N, H // 2, W // 2, 4 * C)


def _stem_s2d_kernel(w):
    """Rearrange the (7, 7, C, O) stride-2 stem kernel into the (4, 4, 4C, O)
    stride-1 kernel that computes the identical map on a space-to-depth
    input: pad to 8x8 (the extra taps are zero), then space-to-depth the
    kernel itself with the same (a, b, c) channel order as the input."""
    _, _, C, O = w.shape
    wp = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
    wp = wp.reshape(4, 2, 4, 2, C, O)
    return wp.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * C, O)


def _nchw(x_nhwc):
    """An NHWC tensor as the channels-last NCHW tensor of the same
    memory (a view when ``x_nhwc`` is contiguous)."""
    return x_nhwc.contiguous().permute(0, 3, 1, 2)


def forward(params, images, cfg: ResNetConfig, batch_stats=None,
            train: bool = True, momentum: float = 0.9):
    """images: (N, H, W, 3) -> logits (N, num_classes).

    Without ``batch_stats`` (the default, the benched training path) BN
    uses batch statistics and only logits return.  With ``batch_stats``
    (from :func:`init_batch_stats`) the call returns ``(logits,
    new_stats)``: train mode still normalizes by batch but EMA-updates the
    running stats; ``train=False`` normalizes by the running stats, making
    eval-mode inference batch-independent."""
    dt = cfg.dtype
    head = params["head"]
    images = torch.as_tensor(images, device=head["w"].device)
    N, H, W, _ = images.shape
    if cfg.stem_space_to_depth and H % 2 == 0 and W % 2 == 0:
        # SAME on the s2d conv reproduces SAME on the original exactly:
        # k=7 s=2 pads (2, 3) on 2H -> k=4 s=1 pads (1, 2) on H
        w = _kernel(_stem_s2d_kernel(params["stem"]["conv"]), dt)
        x = _conv_oihw(_nchw(_space_to_depth(images.to(dt))), w, 1, dt)
    else:
        x = _conv(_nchw(images), params["stem"]["conv"], 2, dt)
    rs = batch_stats
    new_stats = None if rs is None else {"stem": {}, "stages": []}
    x, n = _bn(x, params["stem"]["bn"],
               None if rs is None else rs["stem"]["bn"], train, momentum,
               fold=cfg.bn_fold)
    if rs is not None:
        new_stats["stem"]["bn"] = n
    x = max_pool(torch.relu(x), (3, 3), (2, 2), "SAME")
    for s, stage in enumerate(params["stages"]):
        if rs is not None:
            new_stats["stages"].append([])
        for b, blk in enumerate(stage):
            stride = 2 if (s > 0 and b == 0) else 1
            x, n = _bottleneck(
                x, blk, stride, dt,
                None if rs is None else rs["stages"][s][b], train, momentum,
                fold=cfg.bn_fold)
            if rs is not None:
                new_stats["stages"][s].append(n)
    x = x.mean(dim=(2, 3)).float()                     # global average pool
    logits = x @ head["w"].float() + head["b"]
    return logits if rs is None else (logits, new_stats)


def _softmax_xent(logits, labels):
    """Mean cross entropy of f32 logits against one-hot (or soft) labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels * logp, dim=-1))


def cross_entropy(params, images, labels, cfg: ResNetConfig) -> torch.Tensor:
    return _softmax_xent(forward(params, images, cfg), labels)


def cross_entropy_with_stats(params, batch_stats, images, labels,
                             cfg: ResNetConfig, momentum: float = 0.9):
    """(loss, new_batch_stats) for train loops that maintain running BN
    statistics — use with ``torch.func.grad_and_value(...,
    has_aux=True)``."""
    logits, new_stats = forward(params, images, cfg, batch_stats,
                                train=True, momentum=momentum)
    return _softmax_xent(logits, labels), new_stats


class ResNet:
    def __init__(self, cfg: ResNetConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = None
        self.batch_stats = None

    def init(self, gen: torch.Generator | None = None):
        """Parameters drawn from ``gen`` (default: a CPU generator seeded
        0, so a CPU and a GPU model start from the same values) and fresh
        running stats, on the model's device."""
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        self.params = init_params(gen, self.cfg, self.device)
        self.batch_stats = init_batch_stats(self.cfg, self.device)
        return self.params

    def predict_logits(self, images, use_running_stats: bool = False):
        """``use_running_stats=True`` gives batch-independent eval-mode
        inference (meaningful once training has populated
        ``self.batch_stats`` via ``train_step``)."""
        images = torch.as_tensor(images, device=self.device)
        with torch.no_grad():
            if use_running_stats:
                logits, _ = forward(self.params, images, self.cfg,
                                    batch_stats=self.batch_stats, train=False)
                return logits
            return forward(self.params, images, self.cfg)

    def loss_fn(self):
        """(params, x, y, key) -> scalar, pluggable into parallel.trainer.
        This path trains with batch statistics only; loops that need
        eval-mode inference maintain running stats via
        ``cross_entropy_with_stats`` (see ``train_step``)."""
        cfg = self.cfg
        return lambda p, x, y, k=None: _softmax_xent(forward(p, x, cfg), y)

    def train_step(self, tx):
        """``(params, stats, opt, x, y) -> (params, stats, opt, loss)``
        that maintains running BN statistics alongside training; ``opt``
        is ``(count, tx.init(params))`` with a Python int count."""
        from ..optimize.transforms import apply_updates
        cfg = self.cfg
        grad_fn = torch.func.grad_and_value(cross_entropy_with_stats,
                                            has_aux=True)

        def step(params, stats, opt, x, y):
            count, st = opt
            with exact_f32():
                g, (loss, new_stats) = grad_fn(params, stats, x, y, cfg)
            updates, st = tx.update(g, st, params, count)
            return (apply_updates(params, updates), new_stats,
                    (count + 1, st), loss.detach())

        return step
