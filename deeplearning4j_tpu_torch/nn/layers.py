"""Functional layer modules with named parameter tables.

Port of ``deeplearning4j_tpu/nn/layers.py``.  Layers are stateless
descriptors over dicts of tensors: ``init(gen) -> params`` draws on the
generator's device, ``activate(params, x)`` is pure, and training
differentiates the pure functions with ``torch.func`` (``utils.autodiff``)
as the reference does with ``jax.grad``.  Parameter keys are the
reference's (``W``, ``b``, ``vb``, ``convweights``/``convbias``,
``recurrentweights``/``decoderweights``/``decoderbias``, LSTM's iFog
packing), and so are the layouts (the conv layer is NHWC with HWIO
weights), so parameters cross between the packages as numpy arrays.

Every stochastic step is a draw from a ``torch.Generator`` and
arithmetic on that draw, kept apart (``_draw`` / ``_sample``,
``RBM._cd_draws`` / ``RBM._cd_k``, ``AutoEncoder._corruption_draw`` /
``_loss_from_draw``): torch cannot reproduce the reference's threefry
streams, so the arithmetic is held to the reference on the reference's
own draws.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops import activations as act
from ..ops import convolution as conv
from ..ops import losses as losses_mod
from ..ops.dtypes import get_policy
from ..ops.sampling import _gumbel
from ..ops.sampling import dropout_mask as _mask
from ..utils.autodiff import value_and_grad
from ..utils.tree_math import tree_map
from .conf import (
    LayerKind,
    NeuralNetConfiguration,
    RBMHiddenUnit,
    RBMVisibleUnit,
)
from .weights import init_from_conf

Params = dict[str, torch.Tensor]

# Canonical param-table keys (nn/params/*ParamInitializer.java).
W, B, VBIAS = "W", "b", "vb"
CONV_W, CONV_B = "convweights", "convbias"
REC_W, DEC_W, DEC_B = "recurrentweights", "decoderweights", "decoderbias"


# --------------------------------------------------------------------------- utils

def dropout_mask(gen, shape, rate: float, dtype):
    """Inverted-dropout mask, drawn on ``gen``'s device."""
    return _mask(gen, shape, rate, dtype)


def merge_params(params_list: Sequence[Params]) -> Params:
    """Parameter averaging (``Layer.merge``; used by iterative-reduce DP)."""
    return tree_map(lambda *xs: sum(xs) / float(len(xs)), *params_list)


def flatten_params(params: Params, order: Sequence[str]) -> torch.Tensor:
    """Flatten named params in the deterministic key order."""
    return torch.cat([params[k].reshape(-1) for k in order])


def unflatten_params(flat: torch.Tensor, template: Params,
                     order: Sequence[str]) -> Params:
    out, off = {}, 0
    for k in order:
        size = template[k].numel()
        out[k] = flat[off:off + size].reshape(template[k].shape).to(
            template[k].dtype)
        off += size
    return out


def _mm(a, b):
    """``a @ b`` in the promoted dtype (jnp promotes bf16 @ f32 to f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _zeros(n: int, gen) -> torch.Tensor:
    return torch.zeros((n,), dtype=get_policy().param_dtype, device=gen.device)


def _dropped(conf, x, rng, train):
    if train and conf.dropout > 0 and rng is not None:
        return x * dropout_mask(rng, x.shape, conf.dropout,
                                x.dtype).to(x.device)
    return x


# unit type -> the draw its sample needs
_NOISE = {"binary": "uniform", "gaussian": "normal", "rectified": "normal",
          "softmax": "gumbel", "linear": None}


def _draw(unit, gen, shape, dtype, device):
    """The draw a sample of ``unit`` needs (None for linear units, which
    draw nothing), made on ``gen``'s device and moved to ``device``."""
    kind = _NOISE[unit.value]
    if kind is None:
        return None
    if kind == "gumbel":
        d = _gumbel(gen, shape, dtype)
    elif kind == "uniform":
        d = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    else:
        d = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return d.to(device)


def _sample(unit, mean, pre, noise):
    """A sample of ``unit`` from its mean (and pre-activation) and the
    draw: ``uniform < mean`` (Bernoulli), ``mean + normal`` (Gaussian),
    ``relu(pre + normal * sqrt(sigmoid(pre)))`` (NReLU), the one-hot
    argmax of ``log(mean) + gumbel`` (categorical), or the mean."""
    u = unit.value
    if u == "binary":
        return (noise < mean).to(mean.dtype)
    if u == "gaussian":
        return mean + noise
    if u == "rectified":
        return torch.relu(pre + noise * torch.sqrt(torch.sigmoid(pre)))
    if u == "softmax":
        idx = torch.argmax(noise + torch.log(mean + 1e-12), dim=-1)
        return F.one_hot(idx, mean.shape[-1]).to(mean.dtype)
    if u == "linear":
        return mean
    raise ValueError(unit)


# --------------------------------------------------------------------------- base

class Layer:
    """Descriptor + pure functions; subclasses define param_order, init
    and activate (``nn/api/Layer.java``: activate, preOutput, the param
    table, merge, transpose on the pretrain layers)."""

    kind: LayerKind = LayerKind.DENSE
    param_order: tuple[str, ...] = (W, B)

    def __init__(self, conf: NeuralNetConfiguration):
        self.conf = conf

    # -- params ----------------------------------------------------------
    def init(self, gen) -> Params:
        raise NotImplementedError

    def n_params(self, params: Params) -> int:
        return sum(params[k].numel() for k in self.param_order)

    def flatten(self, params: Params) -> torch.Tensor:
        return flatten_params(params, self.param_order)

    def unflatten(self, flat: torch.Tensor, template: Params) -> Params:
        return unflatten_params(flat, template, self.param_order)

    # -- forward ---------------------------------------------------------
    def pre_output(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train: bool = False) -> torch.Tensor:
        raise NotImplementedError

    # -- shape bookkeeping ----------------------------------------------
    def output_dim(self) -> int:
        return self.conf.n_out


class DenseLayer(Layer):
    """``f(xW + b)`` with dropout (``nn/layers/BaseLayer.java``)."""

    kind = LayerKind.DENSE
    param_order = (W, B)

    def init(self, gen) -> Params:
        conf = self.conf
        return {W: init_from_conf(gen, (conf.n_in, conf.n_out), conf),
                B: _zeros(conf.n_out, gen)}

    def pre_output(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        pol = get_policy()
        return (pol.cast_compute(x) @ pol.cast_compute(params[W])
                + params[B].to(pol.compute_dtype))

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        x = _dropped(self.conf, x, rng, train)
        return act.apply(self.conf.activation, self.pre_output(params, x))


class OutputLayer(DenseLayer):
    """Classifier/regression head (``nn/layers/OutputLayer.java``): the
    loss is a differentiable function of (labels, activated output)."""

    kind = LayerKind.OUTPUT
    param_order = (W, B)

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        return act.apply(self.conf.activation, self.pre_output(params, x))

    def loss(self, params: Params, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        # L2 lives in the gradient-transform chain (transforms.from_conf),
        # as in the reference: adding it here would count it twice.
        out = self.activate(params, x)
        return losses_mod.score(self.conf.loss, labels, out)

    def label_probabilities(self, params: Params,
                            x: torch.Tensor) -> torch.Tensor:
        return self.activate(params, x)


# --------------------------------------------------------------------------- pretrain

class BasePretrainLayer(Layer):
    """``BasePretrainNetwork``: a visible bias, the reconstruction score,
    the sampling SPI and the pretrain gradients."""

    param_order = (W, B, VBIAS)

    def init(self, gen) -> Params:
        conf = self.conf
        return {W: init_from_conf(gen, (conf.n_in, conf.n_out), conf),
                B: _zeros(conf.n_out, gen), VBIAS: _zeros(conf.n_in, gen)}

    def pre_output(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        pol = get_policy()
        return (pol.cast_compute(x) @ pol.cast_compute(params[W])
                + params[B].to(pol.compute_dtype))

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        x = _dropped(self.conf, x, rng, train)
        return act.apply(self.conf.activation, self.pre_output(params, x))

    def transpose(self) -> "BasePretrainLayer":
        """``Layer.transpose()`` — decoder view (W^T, swapped biases)."""
        conf = self.conf.replace(n_in=self.conf.n_out, n_out=self.conf.n_in)
        return type(self)(conf)

    # pretrain gradient SPI — subclasses return (score, grads)
    def pretrain_value_and_grad(self, params: Params, x: torch.Tensor, gen):
        raise NotImplementedError


class AutoEncoder(BasePretrainLayer):
    """Denoising autoencoder: corrupt the input, encode with (W, b),
    decode with (W^T, vb), reconstruction cross-entropy; the gradient by
    autodiff."""

    kind = LayerKind.AUTOENCODER

    def encode(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return act.apply(self.conf.activation, self.pre_output(params, x))

    def decode(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        pol = get_policy()
        z = (pol.cast_compute(h) @ pol.cast_compute(params[W]).T
             + params[VBIAS].to(pol.compute_dtype))
        return act.apply(self.conf.activation, z)

    def reconstruct(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.decode(params, self.encode(params, x))

    def corrupt(self, gen, x: torch.Tensor) -> torch.Tensor:
        """Masking corruption at ``conf.corruption_level``."""
        return self._corrupted(x, self._corruption_draw(gen, x))

    def _corruption_draw(self, gen, x):
        """Uniform draws shaped as ``x`` (None when nothing is corrupted)."""
        if self.conf.corruption_level <= 0:
            return None
        return torch.rand(x.shape, generator=gen, device=gen.device,
                          dtype=torch.float32).to(x.device)

    def _corrupted(self, x, u):
        """``x`` with the entries whose draw is not below the keep
        probability zeroed (``bernoulli(key, keep)`` is ``uniform < keep``)."""
        if u is None:
            return x
        keep = u < 1.0 - self.conf.corruption_level
        return x * keep.to(x.dtype)

    def _loss_from_draw(self, params: Params, x: torch.Tensor, u):
        recon = self.reconstruct(params, self._corrupted(x, u))
        l = losses_mod.reconstruction_crossentropy(x, recon)
        if self.conf.sparsity > 0 or self.conf.apply_sparsity:
            h = self.encode(params, x)
            l = l + torch.mean((torch.mean(h, dim=0) - self.conf.sparsity) ** 2)
        # L2 handled by the transform chain (see OutputLayer.loss).
        return l

    def pretrain_loss(self, params: Params, x: torch.Tensor,
                      gen) -> torch.Tensor:
        return self._loss_from_draw(params, x, self._corruption_draw(gen, x))

    def pretrain_value_and_grad(self, params: Params, x: torch.Tensor, gen):
        u = self._corruption_draw(gen, x)
        return value_and_grad(self._loss_from_draw)(params, x, u)


class RBM(BasePretrainLayer):
    """Restricted Boltzmann machine with CD-k: visible units BINARY /
    GAUSSIAN / SOFTMAX / LINEAR, hidden RECTIFIED / BINARY / GAUSSIAN /
    SOFTMAX, a k-step Gibbs chain, free energy.  The chain's draws are
    made first (``_cd_draws``), then the chain runs on them (``_cd_k``)."""

    kind = LayerKind.RBM

    # -- conditionals ----------------------------------------------------
    def prop_up(self, params: Params, v: torch.Tensor) -> torch.Tensor:
        pre = self.pre_output(params, v)
        hu = self.conf.hidden_unit
        if hu == RBMHiddenUnit.BINARY:
            return torch.sigmoid(pre)
        if hu == RBMHiddenUnit.GAUSSIAN:
            return pre
        if hu == RBMHiddenUnit.RECTIFIED:
            return torch.relu(pre)
        if hu == RBMHiddenUnit.SOFTMAX:
            return torch.softmax(pre, dim=-1)
        raise ValueError(hu)

    def prop_down(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        pol = get_policy()
        pre = (pol.cast_compute(h) @ pol.cast_compute(params[W]).T
               + params[VBIAS].to(pol.compute_dtype))
        vu = self.conf.visible_unit
        if vu == RBMVisibleUnit.BINARY:
            return torch.sigmoid(pre)
        if vu in (RBMVisibleUnit.GAUSSIAN, RBMVisibleUnit.LINEAR):
            return pre
        if vu == RBMVisibleUnit.SOFTMAX:
            return torch.softmax(pre, dim=-1)
        raise ValueError(vu)

    def _hidden_given(self, params, v, noise):
        mean = self.prop_up(params, v)
        pre = (self.pre_output(params, v)
               if self.conf.hidden_unit == RBMHiddenUnit.RECTIFIED else None)
        return mean, _sample(self.conf.hidden_unit, mean, pre, noise)

    def _visible_given(self, params, h, noise):
        mean = self.prop_down(params, h)
        return mean, _sample(self.conf.visible_unit, mean, None, noise)

    def _unit_draw(self, unit, gen, x, width):
        """``unit``'s draw for a layer side of ``width`` units, one row per
        row of ``x``, in the compute dtype."""
        return _draw(unit, gen, tuple(x.shape[:-1]) + (width,),
                     get_policy().compute_dtype, x.device)

    def sample_hidden_given_visible(self, params: Params, v: torch.Tensor,
                                    gen):
        return self._hidden_given(params, v, self._unit_draw(
            self.conf.hidden_unit, gen, v, self.conf.n_out))

    def sample_visible_given_hidden(self, params: Params, h: torch.Tensor,
                                    gen):
        return self._visible_given(params, h, self._unit_draw(
            self.conf.visible_unit, gen, h, self.conf.n_in))

    def gibbs_hvh(self, params: Params, h: torch.Tensor, gen):
        v_mean, v_sample = self.sample_visible_given_hidden(params, h, gen)
        h_mean, h_sample = self.sample_hidden_given_visible(params, v_sample,
                                                            gen)
        return v_mean, v_sample, h_mean, h_sample

    def free_energy(self, params: Params, v: torch.Tensor) -> torch.Tensor:
        """F(v) = -v·vb - sum log(1+exp(xW+b)) (binary-binary form)."""
        pre = self.pre_output(params, v)
        vbias_term = _mm(v, params[VBIAS])
        hidden_term = torch.sum(F.softplus(pre), dim=-1)
        return -vbias_term - hidden_term

    def _cd_draws(self, gen, x: torch.Tensor):
        """The draws of one CD-k update on the batch ``x``: the positive
        phase's hidden draw, then (visible, hidden) for each Gibbs step."""
        hid, vis = self.conf.hidden_unit, self.conf.visible_unit
        h0 = self._unit_draw(hid, gen, x, self.conf.n_out)
        chain = [(self._unit_draw(vis, gen, x, self.conf.n_in),
                  self._unit_draw(hid, gen, x, self.conf.n_out))
                 for _ in range(max(self.conf.k, 1))]
        return h0, chain

    def _cd_k(self, params: Params, x: torch.Tensor, draws):
        """CD-k on the given draws: ``(score, grads)``, grads in descent
        orientation, score the reconstruction cross-entropy of the last
        visible mean."""
        conf = self.conf
        h0, chain = draws
        ph_mean, h = self._hidden_given(params, x, h0)
        for v_noise, h_noise in chain:
            nv_mean, nv_sample = self._visible_given(params, h, v_noise)
            nh_mean, h = self._hidden_given(params, nv_sample, h_noise)
        n = x.shape[0]
        # descent orientation: -(positive - negative)/n
        w_grad = -(_mm(x.T, ph_mean) - _mm(nv_sample.T, nh_mean)) / n
        hb_grad = -torch.mean(ph_mean - nh_mean, dim=0)
        vb_grad = -torch.mean(x - nv_sample, dim=0)
        if conf.sparsity > 0 or conf.apply_sparsity:
            hb_grad = hb_grad + (torch.mean(ph_mean, dim=0) - conf.sparsity)
        # L2 handled by the transform chain (see OutputLayer.loss).
        grads = {W: w_grad.to(params[W].dtype),
                 B: hb_grad.to(params[B].dtype),
                 VBIAS: vb_grad.to(params[VBIAS].dtype)}
        score = losses_mod.reconstruction_crossentropy(x, nv_mean)
        return score, grads

    def pretrain_value_and_grad(self, params: Params, x: torch.Tensor, gen):
        """CD-k gradient (positive phase − negative phase after k Gibbs
        steps): ``(score, grads)`` in descent orientation."""
        return self._cd_k(params, x, self._cd_draws(gen, x))

    def reconstruct(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.prop_down(params, self.prop_up(params, x))


class RecursiveAutoEncoder(BasePretrainLayer):
    """Recursive AE over a left fold of the input rows: combine the
    running parent with the next row, encode, accumulate the
    reconstruction loss.  Requires n_in == n_out."""

    kind = LayerKind.RECURSIVE_AUTOENCODER
    param_order = (W, B, VBIAS)

    def init(self, gen) -> Params:
        conf = self.conf
        # combine [parent; child] (2*d) -> d
        return {W: init_from_conf(gen, (2 * conf.n_in, conf.n_out), conf),
                B: _zeros(conf.n_out, gen), VBIAS: _zeros(2 * conf.n_in, gen)}

    def combine(self, params: Params, parent: torch.Tensor,
                child: torch.Tensor):
        z = torch.cat([parent, child], dim=-1)
        h = act.apply(self.conf.activation, z @ params[W] + params[B])
        recon = act.apply(self.conf.activation,
                          h @ params[W].T + params[VBIAS])
        loss = torch.mean((recon - z) ** 2)
        return h, loss

    def _fold(self, params: Params, x: torch.Tensor):
        parent, hs, ls = x[0], [], []
        for child in x[1:]:
            parent, l = self.combine(params, parent, child)
            hs.append(parent)
            ls.append(l)
        return hs, ls

    def pretrain_loss(self, params: Params, x: torch.Tensor,
                      gen=None) -> torch.Tensor:
        _, ls = self._fold(params, x)
        return torch.mean(torch.stack(ls))

    def pretrain_value_and_grad(self, params: Params, x: torch.Tensor, gen):
        return value_and_grad(self.pretrain_loss)(params, x, gen)

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        hs, _ = self._fold(params, x)
        return torch.cat([x[:1], torch.stack(hs)], dim=0)


# --------------------------------------------------------------------------- recurrent

class LSTM(Layer):
    """Single-layer LSTM (char-rnn style): the i/f/o/g gates in ONE
    concatenated weight matrix (the reference's iFog), input
    [1, x_t, h_{t-1}] (the leading 1 folds the bias in), a decoder head
    with per-step softmax.  BPTT by autodiff through the time loop."""

    kind = LayerKind.LSTM
    param_order = (REC_W, DEC_W, DEC_B)

    def init(self, gen) -> Params:
        conf = self.conf
        d = conf.hidden_size or conf.n_out
        rec = init_from_conf(gen, (1 + conf.n_in + d, 4 * d), conf)
        dec = init_from_conf(gen, (d, conf.n_out), conf)
        return {REC_W: rec, DEC_W: dec, DEC_B: _zeros(conf.n_out, gen)}

    def _step(self, params: Params, carry, x_t):
        h_prev, c_prev = carry
        d = h_prev.shape[-1]
        ones = torch.ones(x_t.shape[:-1] + (1,), dtype=x_t.dtype,
                          device=x_t.device)
        inp = torch.cat([ones, x_t, h_prev], dim=-1)
        gates = inp @ params[REC_W]
        i = torch.sigmoid(gates[..., 0:d])
        f = torch.sigmoid(gates[..., d:2 * d])
        o = torch.sigmoid(gates[..., 2 * d:3 * d])
        g = torch.tanh(gates[..., 3 * d:4 * d])
        c = f * c_prev + i * g
        h = o * torch.tanh(c)
        return (h, c), h

    def hidden_states(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (T, n_in) or (B, T, n_in) -> hidden (T, d) / (B, T, d)."""
        d = self.conf.hidden_size or self.conf.n_out
        batched = x.dim() == 3
        lead = (x.shape[0],) if batched else ()
        zero = torch.zeros(lead + (d,), dtype=x.dtype, device=x.device)
        carry = (zero, zero)
        xs = x.transpose(0, 1) if batched else x       # (T, [B,] n_in)
        hs = []
        for x_t in xs:
            carry, h = self._step(params, carry, x_t)
            hs.append(h)
        hs = torch.stack(hs)
        return hs.transpose(0, 1) if batched else hs

    def pre_output(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        hs = self.hidden_states(params, x)
        return hs @ params[DEC_W] + params[DEC_B]

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        x = _dropped(self.conf, x, rng, train)
        return act.apply(self.conf.activation, self.pre_output(params, x))

    def loss(self, params: Params, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Per-step softmax cross entropy."""
        logits = self.pre_output(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.sum(labels * logp, dim=-1))


# --------------------------------------------------------------------------- conv

class ConvolutionDownSampleLayer(Layer):
    """conv2d + bias + activation + max-pool.

    Layout: NHWC activations and HWIO weights, the reference's (so its
    weights carry across unchanged); the convolution itself runs NCHW /
    OIHW (``ops.convolution``), permuted at the call."""

    kind = LayerKind.CONVOLUTION_DOWNSAMPLE
    param_order = (CONV_W, CONV_B)

    def init(self, gen) -> Params:
        conf = self.conf
        fh, fw = conf.filter_size
        cin = conf.n_in or 1
        return {CONV_W: init_from_conf(gen, (fh, fw, cin, conf.num_filters),
                                       conf),
                CONV_B: _zeros(conf.num_filters, gen)}

    def _pre_nchw(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        pol = get_policy()
        x4 = x if x.dim() == 4 else x[..., None]
        y = conv.conv2d(pol.cast_compute(x4).permute(0, 3, 1, 2),
                        pol.cast_compute(params[CONV_W]).permute(3, 2, 0, 1),
                        (1, 1), self.conf.padding)
        return y + params[CONV_B].to(y.dtype)[:, None, None]

    def pre_output(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self._pre_nchw(params, x).permute(0, 2, 3, 1)

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        y = act.apply(self.conf.activation, self._pre_nchw(params, x))
        sh, sw = self.conf.stride
        return F.max_pool2d(y, (sh, sw), (sh, sw)).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------- beyond-v0 blocks

class BatchNorm(Layer):
    """Batch normalization over every axis but the last."""

    kind = LayerKind.BATCHNORM
    param_order = ("scale", "bias")

    def init(self, gen) -> Params:
        d = self.conf.n_out or self.conf.n_in
        return {"scale": torch.ones((d,), dtype=get_policy().param_dtype,
                                    device=gen.device),
                "bias": _zeros(d, gen)}

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        axes = tuple(range(x.dim() - 1))
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.var(x, dim=axes, keepdim=True, correction=0)
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        return xn * params["scale"] + params["bias"]


class Embedding(Layer):
    """Token embedding lookup."""

    kind = LayerKind.EMBEDDING
    param_order = (W,)

    def init(self, gen) -> Params:
        conf = self.conf
        return {W: init_from_conf(gen, (conf.n_in, conf.n_out), conf)}

    def activate(self, params: Params, x: torch.Tensor, *, rng=None,
                 train=False):
        return params[W][x.long()]

    def pre_output(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.activate(params, x)


# --------------------------------------------------------------------------- registry

REGISTRY: dict[LayerKind, type[Layer]] = {
    LayerKind.DENSE: DenseLayer,
    LayerKind.OUTPUT: OutputLayer,
    LayerKind.RBM: RBM,
    LayerKind.AUTOENCODER: AutoEncoder,
    LayerKind.RECURSIVE_AUTOENCODER: RecursiveAutoEncoder,
    LayerKind.LSTM: LSTM,
    LayerKind.CONVOLUTION_DOWNSAMPLE: ConvolutionDownSampleLayer,
    LayerKind.BATCHNORM: BatchNorm,
    LayerKind.EMBEDDING: Embedding,
}


def create_layer(conf: NeuralNetConfiguration) -> Layer:
    """``LayerFactories.getFactory(conf).create(conf)`` equivalent."""
    try:
        cls = REGISTRY[conf.kind]
    except KeyError:
        raise ValueError(f"no layer registered for kind {conf.kind}") from None
    return cls(conf)
