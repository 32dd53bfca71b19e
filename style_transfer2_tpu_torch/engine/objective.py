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
  * The trace: per-branch loss and gradient-RMS scalars in evaluation order,
    then scd_loss, t_loss, p_loss, scd_grad, t_grad, p_grad, loss, grad.

make_lane_objective is the same objective over B independent images
stacked on a leading lane axis (the batched engine; JAX: jax.vmap of the
objective): one trunk forward and backward at N = B, the style branch over
all lanes in one call, every weight, scalar and norm a (B,) value and
every reduction per lane, so that nothing mixes two lanes.

This ports the JAX package's float32-feed branches. In bfloat16 mode the
trunk runs in bf16 and its taps come back as float32, so every loss here is
float32 math in both modes. The JAX package's bf16 loss-feed variants
(BF16_FEED, BF16_TAPS, STYLE_EINSUM, STYLE_FOLD) and the video temporal term
are not ported.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..models import vgg19
from ..ops.losses import p_norm, p_norm_lanes, tv_norm, tv_norm_lanes
from ..ops.style import fused_style_branch

# Weights with |w| <= this are treated as absent (reference worker.py:234,250).
WEIGHT_EPS = 1e-15
LOSS_NAMES = ('content', 'style', 'deepdream')
SCALAR_LOSS_NAMES = ('tv', 'tv_power', 'p', 'p_power')


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

    @classmethod
    def from_weights(cls, weights, params):
        """Builds a spec from weights[loss_name][layer] -> float and the
        scalar params dict with tv/tv_power/p/p_power."""
        branches = []
        for layer in vgg19.BLOB_NAMES:
            has = []
            for loss_name in LOSS_NAMES:
                w = weights.get(loss_name, {}).get(layer, 0.0)
                has.append(w is not None and abs(float(w)) > WEIGHT_EPS)
            if any(has):
                branches.append((layer, has[0], has[1], has[2]))
        return cls(branches=tuple(branches),
                   tv_power=float(params.get('tv_power', 2.0)),
                   p_power=float(params.get('p_power', 2.0)))

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
        keys += ['scd_loss', 't_loss', 'p_loss', 'scd_grad', 't_grad',
                 'p_grad', 'loss', 'grad']
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
    """The tv/p scalar weights as float32 numpy scalars (the powers live in
    the spec)."""
    return {'tv': np.float32(params.get('tv', 1.0)),
            'p': np.float32(params.get('p', 1.0))}


def empty_norms(spec):
    """Fresh norm state: all (0, unset)."""
    vals = {k: np.float32(0.0) for k in spec.norm_keys}
    set_ = {k: np.bool_(False) for k in spec.norm_keys}
    return vals, set_


def make_objective(spec):
    """Returns objective(model, x, content_feats, grams, layer_weights,
    scalars, norms_vals, norms_set) -> (loss, grad, (norms_vals',
    norms_set'), trace) where model is a VGG19Features, every other input a
    tensor or dict of tensors on x's device, and trace a tuple of 0-d
    tensors in spec.trace_keys order."""

    def objective(model, x, content_feats, grams, layer_weights, scalars,
                  norms_vals, norms_set):
        feats, vjp = model.features_and_vjp(x, spec.layers)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        trace = []
        diffs = {}
        new_vals = dict(norms_vals)
        new_set = dict(norms_set)
        is_set = torch.ones((), dtype=torch.bool, device=x.device)

        def norm_of(key, fresh):
            """First-eval RMS caching: the stored norm if set, else the
            fresh one; set either way (worker.py:253-254)."""
            value = torch.where(norms_set[key], norms_vals[key], fresh)
            new_vals[key] = value
            new_set[key] = is_set
            return value

        for layer, has_c, has_s, has_d in spec.branches:
            feat = feats[layer]
            size = float(feat.numel())
            w = layer_weights[layer]
            diff = torch.zeros_like(feat, dtype=torch.float32)

            if has_c:
                cw = w[0]
                c_diff = feat - content_feats[layer]
                c_grad = (2.0 / size) * c_diff
                cn = norm_of(layer + ':c', _rms(c_grad))
                c_loss = cw * torch.mean(torch.square(c_diff)) / cn
                trace.append(c_loss)
                loss = loss + c_loss
                term = cw * c_grad / cn
                trace.append(_rms(term))
                diff = diff + term

            if has_s:
                sw = w[1]
                s_grad, gram_diff = fused_style_branch(feat, grams[layer])
                sn = norm_of(layer + ':s', _rms(s_grad))
                s_loss = sw * torch.mean(torch.square(gram_diff)) / sn
                trace.append(s_loss)
                loss = loss + s_loss
                term = (sw / sn) * s_grad
                trace.append(_rms(term))
                diff = diff + term

            if has_d:
                dw = w[2]
                d_grad = (-2.0 / size) * feat
                dn = norm_of(layer + ':d', _rms(d_grad))
                d_loss = -dw * torch.mean(torch.square(feat)) / dn
                trace.append(d_loss)
                loss = loss + d_loss
                term = dw * d_grad / dn
                trace.append(_rms(term))
                diff = diff + term

            diffs[layer] = diff.to(feat.dtype)

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

        grad = vjp(diffs)
        trace.append(_rms(grad))  # scd_grad
        tv_term = scalars['tv'] * tv_grad
        trace.append(_rms(tv_term))  # t_grad
        grad = grad + tv_term
        p_term = scalars['p'] * p_grad
        trace.append(_rms(p_term))  # p_grad
        grad = grad + p_term

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

        for layer, has_c, has_s, has_d in spec.branches:
            feat = feats[layer]
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
