"""The style-transfer objective (style_transfer2_tpu/engine/objective.py;
reference StyleTransfer.opfunc, worker.py:231-301).

  * Per-layer content, style and deep-dream losses with analytic gradients,
    each divided by a first-evaluation gradient-RMS norm that is kept until
    reset (worker.py:137,253-277). The norms are explicit state: per (layer,
    kind) a value and an is-set flag, 0-d tensors on the device.
  * The style gradient is the reference's half-gradient
    2/(c^2 * chw) * feat @ gram_diff, computed with the Gram difference by
    ops.style.fused_style_branch (the CUDA kernel on the card) and injected
    as a vjp cotangent with the other per-layer terms.
  * TV and p-norm act on x/255; their analytic gradients are added WITHOUT
    the 1/255 factor (worker.py:283-297, a reference quirk kept on purpose).
  * The video temporal-consistency term (spec.temporal): tw * mean(((x -
    target)/255)^2) toward the previous stylized frame, with its true
    gradient, in float32 in every precision.
  * The trace: per-branch loss and gradient-RMS scalars in evaluation order,
    then scd_loss, t_loss, p_loss, [temporal_loss,] scd_grad, t_grad,
    p_grad, [temporal_grad,] loss, grad.

make_lane_objective is the same objective over B independent images
stacked on a leading lane axis (the batched engine; JAX: jax.vmap of the
objective): one trunk forward and backward at N = B, the style branch over
all lanes in one call, every weight, scalar and norm a (B,) value and
every reduction per lane, so that nothing mixes two lanes. It has no
temporal term, as the JAX batched engine has none.

float32 and float32_fast run the JAX package's float32-feed branches:
float32 taps, float32 cotangents, the fused style branch, each tap's
cotangent and the sums behind its loss and trace from ops/epilogue.py
tap_epilogue (one kernel a tap on the card, _f32_layer). bfloat16 runs its
bf16 loss feed, as the JAX package ships it (BF16_FEED with STYLE_EINSUM
and STYLE_FOLD = 'auto', style_transfer2_tpu/engine/objective.py), with no
switch back (_feed_layer):
  * the conv and pool taps stay bf16 (models/vgg19.py features_and_vjp)
    and the engines store content features in bf16 (content_store_dtype),
    so `feat - content` stays bf16;
  * every sum of squares is float32 over the bf16 values (ops/reduce.py
    sumsq), and the loss and both RMS traces of a branch follow from it by
    scalar algebra;
  * each cotangent is built in the tap's dtype, each scale rounded to it
    before it multiplies the tap (JAX's scale.astype(feat.dtype): torch
    would multiply a float32 0-d scale into a bf16 tensor in float and
    round once);
  * the style branch is its two phases over the bf16 tap (ops/style.py
    style_gram, float32 sums; style_product, a bf16 result); from
    STYLE_FOLD_MIN_PIXELS pixels an image the scale is folded into the
    (c, c) Gram difference before the product, and rms(s_raw) comes from
    the Gram: sumsq(s_raw) / size = sum((gd @ gd) * gram).
The 'data' tap is x itself, float32, in every mode: there the feed's
branches run in float32 (its content feature is stored bf16 and cast back,
as in the JAX engine).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..models import vgg19
from ..ops.epilogue import tap_epilogue
from ..ops.losses import p_norm, p_norm_lanes, tv_norm, tv_norm_lanes
from ..ops.reduce import sumsq
from ..ops.style import fused_style_branch, style_gram, style_product
from ..utils import tf32

# Weights with |w| <= this are treated as absent (reference worker.py:234,250).
WEIGHT_EPS = 1e-15
LOSS_NAMES = ('content', 'style', 'deepdream')
SCALAR_LOSS_NAMES = ('tv', 'tv_power', 'p', 'p_power')
# The bf16 feed folds the style scale into the Gram difference on grids of
# at least this many pixels an image (the JAX package's STYLE_FOLD 'auto'
# floor; read at each call).
STYLE_FOLD_MIN_PIXELS = 500_000


def content_store_dtype(compute_dtype):
    """The dtype the engines store content features in: the compute dtype
    in bfloat16 (the feed's `feat - content` stays bf16), float32
    otherwise."""
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def _style_fold(x):
    """Whether the bf16 feed folds the style scale at iterate x: its grid
    (an image's; the whole image of a Sharded x) has at least
    STYLE_FOLD_MIN_PIXELS pixels."""
    return x.shape[-3] * x.shape[-2] >= STYLE_FOLD_MIN_PIXELS


def _feed_layer(layer, branch, feat, w, content, gram_style, norm_of,
                trace, loss, fold, lanes):
    """The bf16 loss feed of one tapped layer (module docstring; JAX
    objective.py's bf16_feed branches): appends each term's loss and
    gradient RMS to trace and returns (loss with the layer's terms added,
    the layer's cotangent in feat's dtype). With lanes, feat is (B, h, w,
    c) and every weight, norm and sum (B,)."""
    _, has_c, has_s, has_d = branch
    dt = feat.dtype
    size = float(feat[0].numel()) if lanes else float(feat.numel())

    def col(v):
        """A scale as a multiplier of the tap (_col of lanes)."""
        return _col(v) if lanes else v

    def weight(i):
        return w[:, i] if lanes else w[i]

    diff = None

    def add(term):
        return term if diff is None else diff + term

    if has_c:
        cw = weight(0)
        c_diff = feat - content.to(dt)
        sq = sumsq(c_diff, lanes)
        cn = norm_of(layer + ':c', (2.0 / size) * torch.sqrt(sq / size))
        c_loss = cw * (sq / size) / cn
        trace.append(c_loss)
        loss = loss + c_loss
        scale = cw * (2.0 / size) / cn
        trace.append(torch.abs(scale) * torch.sqrt(sq / size))
        diff = add(col(scale.to(dt)) * c_diff)

    if has_s:
        sw = weight(1)
        n = feat.shape[-1]
        gram = style_gram(feat, size, lanes)
        gram_diff = gram - gram_style
        k = 2.0 / (float(n * n) * size)
        dims = (1, 2) if lanes else None
        mean_sq = torch.mean(torch.square(gram_diff), dim=dims)
        if fold:
            # rms(s_raw) from the Gram, the (c, c) product in full float32
            # (JAX: precision 'highest').
            with tf32(False):
                gd2 = gram_diff @ gram_diff
            rms_raw = torch.sqrt(torch.clamp(
                torch.sum(gd2 * gram, dim=dims), min=0.0))
        else:
            s_raw = style_product(feat, gram_diff)
            rms_raw = torch.sqrt(sumsq(s_raw, lanes) / size)
        sn = norm_of(layer + ':s', k * rms_raw)
        s_loss = sw * mean_sq / sn
        trace.append(s_loss)
        loss = loss + s_loss
        scale = sw * k / sn
        trace.append(torch.abs(scale) * rms_raw)
        if fold:
            d = (scale[:, None, None] if lanes else scale) * gram_diff
            diff = add(style_product(feat, d))
        else:
            diff = add(col(scale.to(dt)) * s_raw)

    if has_d:
        dw = weight(2)
        rms_feat = torch.sqrt(sumsq(feat, lanes) / size)
        dn = norm_of(layer + ':d', (2.0 / size) * rms_feat)
        d_loss = -dw * torch.square(rms_feat) / dn
        trace.append(d_loss)
        loss = loss + d_loss
        scale = dw * (-2.0 / size) / dn
        trace.append(torch.abs(scale) * rms_feat)
        diff = add(col(scale.to(dt)) * feat)

    return loss, diff


def _f32_layer(layer, branch, feat, w, content, gram_style, norm_of, trace,
               loss, fresh_norms):
    """The float32 feed of one tapped layer (the JAX package's float32
    branches): appends each term's loss and gradient RMS to trace and
    returns (loss with the layer's terms added, the layer's float32
    cotangent). The cotangent and the sums behind the terms' losses and
    RMS traces come from ops/epilogue.py tap_epilogue (the kernel on a CUDA
    tap); a fresh norm, where wanted, is the RMS of the term's raw
    gradient as PyTorch reduces it."""
    _, has_c, has_s, has_d = branch
    size = float(feat.numel())

    def norm(kind, raw_grad):
        return norm_of(layer + kind,
                       _rms(raw_grad()) if fresh_norms else None)

    cn = sn = dn = s_grad = s_scale = None
    if has_c:
        cn = norm(':c', lambda: (2.0 / size) * (feat - content))
    if has_s:
        s_grad, gram_diff = fused_style_branch(feat, gram_style)
        sn = norm(':s', lambda: s_grad)
        s_scale = w[1] / sn
    if has_d:
        dn = norm(':d', lambda: (-2.0 / size) * feat)
    diff, sums = tap_epilogue(feat, w, content if has_c else None, cn,
                              s_grad, s_scale, dn)

    if has_c:
        c_loss = w[0] * (sums[0] / size) / cn
        trace.append(c_loss)
        loss = loss + c_loss
        trace.append(torch.sqrt(sums[1] / size))
    if has_s:
        s_loss = w[1] * torch.mean(torch.square(gram_diff)) / sn
        trace.append(s_loss)
        loss = loss + s_loss
        trace.append(torch.sqrt(sums[2] / size))
    if has_d:
        d_loss = -w[2] * (sums[3] / size) / dn
        trace.append(d_loss)
        loss = loss + d_loss
        trace.append(torch.sqrt(sums[4] / size))
    return loss, diff


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)))


def _rms_lanes(x):
    """(B,) RMS of each lane of a (B, ...) tensor."""
    return torch.sqrt(torch.mean(torch.square(x),
                                 dim=tuple(range(1, x.dim()))))


def _col(v):
    """A (B,) tensor as (B, 1, 1, 1), to scale (B, h, w, c) lanes."""
    return v[:, None, None, None]


@dataclass(frozen=True)
class ObjectiveSpec:
    """Which (layer, loss) branches are active, and the tv/p exponents."""

    branches: tuple  # ((layer_name, has_content, has_style, has_dream), ...)
    tv_power: float = 2.0
    p_power: float = 2.0
    # The video temporal-consistency term toward a previous stylized frame.
    temporal: bool = False

    @classmethod
    def from_weights(cls, weights, params):
        """Builds a spec from weights[loss_name][layer] -> float and the
        scalar params dict with tv/tv_power/p/p_power (and temporal)."""
        branches = []
        for layer in vgg19.BLOB_NAMES:
            has = []
            for loss_name in LOSS_NAMES:
                w = weights.get(loss_name, {}).get(layer, 0.0)
                has.append(w is not None and abs(float(w)) > WEIGHT_EPS)
            if any(has):
                branches.append((layer, has[0], has[1], has[2]))
        temporal = abs(float(params.get('temporal', 0.0) or 0.0)) > WEIGHT_EPS
        return cls(branches=tuple(branches),
                   tv_power=float(params.get('tv_power', 2.0)),
                   p_power=float(params.get('p_power', 2.0)),
                   temporal=temporal)

    @property
    def layers(self):
        return tuple(b[0] for b in self.branches)

    @property
    def content_layers(self):
        return tuple(b[0] for b in self.branches if b[1])

    @property
    def style_layers(self):
        return tuple(b[0] for b in self.branches if b[2])

    @property
    def norm_keys(self):
        """Keys of the first-eval norm state, in branch order."""
        keys = []
        for layer, has_c, has_s, has_d in self.branches:
            if has_c:
                keys.append(layer + ':c')
            if has_s:
                keys.append(layer + ':s')
            if has_d:
                keys.append(layer + ':d')
        return tuple(keys)

    @property
    def trace_keys(self):
        """Names of the objective's trace scalars, in reference order."""
        keys = []
        for layer, has_c, has_s, has_d in self.branches:
            if has_c:
                keys += ['%s_c_loss' % layer, '%s_c_grad' % layer]
            if has_s:
                keys += ['%s_s_loss' % layer, '%s_s_grad' % layer]
            if has_d:
                keys += ['%s_d_loss' % layer, '%s_d_grad' % layer]
        keys += ['scd_loss', 't_loss', 'p_loss']
        if self.temporal:
            keys += ['temporal_loss']
        keys += ['scd_grad', 't_grad', 'p_grad']
        if self.temporal:
            keys += ['temporal_grad']
        keys += ['loss', 'grad']
        return tuple(keys)


def weights_to_arrays(weights, spec):
    """Per-layer weight vectors [content, style, deepdream] for the spec's
    layers, as float32 numpy; missing entries are 0."""
    out = {}
    for layer in spec.layers:
        vals = []
        for loss_name in LOSS_NAMES:
            w = weights.get(loss_name, {}).get(layer, 0.0)
            vals.append(0.0 if w is None else float(w))
        out[layer] = np.float32(vals)
    return out


def scalars_to_arrays(params):
    """The tv/p (and, where set, temporal) scalar weights as float32 numpy
    scalars (the powers live in the spec)."""
    out = {'tv': np.float32(params.get('tv', 1.0)),
           'p': np.float32(params.get('p', 1.0))}
    if params.get('temporal'):
        out['temporal'] = np.float32(params['temporal'])
    return out


def empty_norms(spec):
    """Fresh norm state: all (0, unset)."""
    vals = {k: np.float32(0.0) for k in spec.norm_keys}
    set_ = {k: np.bool_(False) for k in spec.norm_keys}
    return vals, set_


def make_objective(spec):
    """Returns objective(model, x, content_feats, grams, layer_weights,
    scalars, norms_vals, norms_set, temporal_target=None, fresh_norms=True)
    -> (loss, grad, (norms_vals', norms_set'), trace) where model is a
    VGG19Features, every other input a tensor or dict of tensors on x's
    device (temporal_target an x-shaped float32 tensor where
    spec.temporal), and trace a tuple of 0-d tensors in spec.trace_keys
    order. fresh_norms=False promises that every norm of the spec is set
    (an L-BFGS step, after the prime of its spec set them): the float32
    feed then takes the stored norms without computing fresh ones, which
    the set flags would discard."""

    def objective(model, x, content_feats, grams, layer_weights, scalars,
                  norms_vals, norms_set, temporal_target=None,
                  fresh_norms=True):
        feats, vjp = model.features_and_vjp(x, spec.layers)
        feed = model.compute_dtype == torch.bfloat16
        fold = feed and _style_fold(x)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        trace = []
        diffs = {}
        new_vals = dict(norms_vals)
        new_set = dict(norms_set)
        is_set = torch.ones((), dtype=torch.bool, device=x.device)

        def norm_of(key, fresh):
            """First-eval RMS caching: the stored norm if set, else the
            fresh one; set either way (worker.py:253-254). fresh None: the
            stored norm, which the caller knows is set."""
            value = (norms_vals[key] if fresh is None else
                     torch.where(norms_set[key], norms_vals[key], fresh))
            new_vals[key] = value
            new_set[key] = is_set
            return value

        for branch in spec.branches:
            layer = branch[0]
            feat = feats[layer]
            if feed:
                loss, diffs[layer] = _feed_layer(
                    layer, branch, feat, layer_weights[layer],
                    content_feats.get(layer), grams.get(layer), norm_of,
                    trace, loss, fold, False)
            else:
                loss, diffs[layer] = _f32_layer(
                    layer, branch, feat, layer_weights[layer],
                    content_feats.get(layer), grams.get(layer), norm_of,
                    trace, loss, fresh_norms)

        trace.append(loss)  # scd_loss

        x_scaled = x / 255.0
        tv_loss, tv_grad = tv_norm(x_scaled, spec.tv_power)
        t_loss = scalars['tv'] * tv_loss
        trace.append(t_loss)
        loss = loss + t_loss

        p_loss, p_grad = p_norm(x_scaled, spec.p_power)
        pl = scalars['p'] * p_loss
        trace.append(pl)
        loss = loss + pl

        if spec.temporal:
            # The true gradient of tw * mean(((x - target)/255)^2).
            t_diff = (x - temporal_target) / 255.0
            tmp_loss = scalars['temporal'] * torch.mean(torch.square(t_diff))
            trace.append(tmp_loss)
            loss = loss + tmp_loss
            tmp_grad = scalars['temporal'] * (2.0 / (x.numel() * 255.0)) \
                * t_diff

        grad = vjp(diffs)
        trace.append(_rms(grad))  # scd_grad
        tv_term = scalars['tv'] * tv_grad
        trace.append(_rms(tv_term))  # t_grad
        grad = grad + tv_term
        p_term = scalars['p'] * p_grad
        trace.append(_rms(p_term))  # p_grad
        grad = grad + p_term

        if spec.temporal:
            trace.append(_rms(tmp_grad))  # temporal_grad
            grad = grad + tmp_grad

        trace.append(loss)        # loss
        trace.append(_rms(grad))  # grad
        return loss, grad, (new_vals, new_set), tuple(trace)

    return objective


def make_lane_objective(spec):
    """make_objective over B lanes: objective(model, x, content_feats,
    grams, layer_weights, scalars, norms_vals, norms_set) -> (loss, grad,
    (norms_vals', norms_set'), trace) with x (B, H, W, 3), content_feats
    (B, h, w, c) per layer, grams (B, c, c), layer_weights (B, 3), scalars
    and norms (B,) per key; loss (B,), grad (B, H, W, 3), the trace a tuple
    of (B,) tensors in spec.trace_keys order."""

    def objective(model, x, content_feats, grams, layer_weights, scalars,
                  norms_vals, norms_set):
        feats, vjp = model.features_and_vjp(x, spec.layers)
        feed = model.compute_dtype == torch.bfloat16
        fold = feed and _style_fold(x)
        n_lanes = x.shape[0]
        loss = torch.zeros(n_lanes, dtype=torch.float32, device=x.device)
        trace = []
        diffs = {}
        new_vals = dict(norms_vals)
        new_set = dict(norms_set)
        is_set = torch.ones(n_lanes, dtype=torch.bool, device=x.device)

        def norm_of(key, fresh):
            """norm_of of make_objective, per lane."""
            value = torch.where(norms_set[key], norms_vals[key], fresh)
            new_vals[key] = value
            new_set[key] = is_set
            return value

        for branch in spec.branches:
            layer, has_c, has_s, has_d = branch
            feat = feats[layer]
            if feed:
                loss, diffs[layer] = _feed_layer(
                    layer, branch, feat, layer_weights[layer],
                    content_feats.get(layer), grams.get(layer), norm_of,
                    trace, loss, fold, True)
                continue
            size = float(feat[0].numel())
            w = layer_weights[layer]
            diff = torch.zeros_like(feat, dtype=torch.float32)

            if has_c:
                cw = w[:, 0]
                c_diff = feat - content_feats[layer]
                c_grad = (2.0 / size) * c_diff
                cn = norm_of(layer + ':c', _rms_lanes(c_grad))
                c_loss = cw * torch.mean(torch.square(c_diff),
                                         dim=(1, 2, 3)) / cn
                trace.append(c_loss)
                loss = loss + c_loss
                term = _col(cw) * c_grad / _col(cn)
                trace.append(_rms_lanes(term))
                diff = diff + term

            if has_s:
                sw = w[:, 1]
                s_grad, gram_diff = fused_style_branch(feat, grams[layer])
                sn = norm_of(layer + ':s', _rms_lanes(s_grad))
                s_loss = sw * torch.mean(torch.square(gram_diff),
                                         dim=(1, 2)) / sn
                trace.append(s_loss)
                loss = loss + s_loss
                term = _col(sw / sn) * s_grad
                trace.append(_rms_lanes(term))
                diff = diff + term

            if has_d:
                dw = w[:, 2]
                d_grad = (-2.0 / size) * feat
                dn = norm_of(layer + ':d', _rms_lanes(d_grad))
                d_loss = -dw * torch.mean(torch.square(feat),
                                          dim=(1, 2, 3)) / dn
                trace.append(d_loss)
                loss = loss + d_loss
                term = _col(dw) * d_grad / _col(dn)
                trace.append(_rms_lanes(term))
                diff = diff + term

            diffs[layer] = diff.to(feat.dtype)

        trace.append(loss)  # scd_loss

        x_scaled = x / 255.0
        tv_loss, tv_grad = tv_norm_lanes(x_scaled, spec.tv_power)
        t_loss = scalars['tv'] * tv_loss
        trace.append(t_loss)
        loss = loss + t_loss

        p_loss, p_grad = p_norm_lanes(x_scaled, spec.p_power)
        pl = scalars['p'] * p_loss
        trace.append(pl)
        loss = loss + pl

        grad = vjp(diffs)
        trace.append(_rms_lanes(grad))  # scd_grad
        tv_term = _col(scalars['tv']) * tv_grad
        trace.append(_rms_lanes(tv_term))  # t_grad
        grad = grad + tv_term
        p_term = _col(scalars['p']) * p_grad
        trace.append(_rms_lanes(p_term))  # p_grad
        grad = grad + p_term

        trace.append(loss)              # loss
        trace.append(_rms_lanes(grad))  # grad
        return loss, grad, (new_vals, new_set), tuple(trace)

    return objective
