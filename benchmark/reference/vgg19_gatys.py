"""The plain reference of the vgg19-gatys configurations: VGG-19 (configuration
E) to the objective's deepest tap, the Gatys et al. objective as the original
worker computed it, fixed-step L-BFGS and the lanczos3 warm start of a
coarse-to-fine ladder.

Plain PyTorch, NCHW, float32 with TF32 off in cuBLAS and cuDNN. It imports
nothing of the program under test and takes nothing the program made: the
weights, the content and style images and the random starts are handed to it
as the benchmark made them, and it works out the content features, the Grams,
the first-evaluation norms and every step again.

`precision` selects what runs the convolutions and the Gram products:
'float32' is the reference; 'tf32' (TF32 on) and 'fp8' (each operand rounded
to float8 e4m3 with a per-tensor scale, float32 accumulation, forward and
backward alike, and the taps rounded before the losses) are the lower
precisions that serve as the comparison's controls; 'float64' (weights,
images and every operation in float64) is the yardstick a float32 gradient's
rounding error is read against (portbench/check.py, classify).

The objective (the original worker's opfunc, in its order):
  * per tapped layer in forward order: content loss cw * mean((f - c)^2) / cn
    with the cotangent cw * 2/size * (f - c) / cn; style loss
    sw * mean(gd^2) / sn with gd = gram(f) - gram(style) and the cotangent
    (sw / sn) * 2 / (C^2 * C*M) * gd @ f; cn and sn the RMS of the unscaled
    gradients at the first evaluation after a reset, kept until the next;
  * the input gradient is the vjp of the trunk with those cotangents;
  * TV (power tv_power) and the p-norm (power p_power) act on x / 255 and add
    their gradients without the 1/255 factor (a quirk of the original, kept);
  * the trace: each term's loss and the RMS of its gradient, then scd_loss,
    t_loss, p_loss, scd_grad, t_grad, p_grad, loss, grad.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # float8 e4m3's largest finite value


def _q8(t):
    """t rounded to float8 e4m3 with a per-tensor scale, back in float32."""
    amax = t.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Conv8(torch.autograd.Function):
    """3x3 conv (padding 1) with float8 operands in both directions."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = _q8(x), _q8(w)
        ctx.save_for_backward(wq)
        ctx.x_shape = x.shape
        return F.conv2d(xq, wq, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        (wq,) = ctx.saved_tensors
        dx = torch.nn.grad.conv2d_input(ctx.x_shape, wq, _q8(g), padding=1)
        return dx, None, None


class Precision:
    """How the reference runs its convolutions and Gram products."""

    def __init__(self, name):
        if name not in ('float32', 'tf32', 'fp8', 'float64'):
            raise ValueError('precision %r' % (name,))
        self.name = name
        self.dtype = torch.float64 if name == 'float64' else torch.float32

    @contextlib.contextmanager
    def scope(self):
        """TF32 on for 'tf32', off otherwise, around the work inside."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.name == 'tf32'
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def conv(self, x, w, b):
        if self.name == 'fp8':
            return _Conv8.apply(x, w, b)
        return F.conv2d(x, w, b, padding=1)

    def tap(self, f):
        return _q8(f) if self.name == 'fp8' else f


class VGG:
    """VGG-19 E from NCHW float32 weights: conv + ReLU taps, 2x2 max pools
    in ceil mode. convs: [(name, cin, cout), ...] in forward order."""

    def __init__(self, convs, weights, precision):
        self.convs = [tuple(c) for c in convs]
        self.weights = weights         # name -> (w OIHW, b)
        self.precision = precision
        self.blobs = []
        block = None
        for name, _, _ in self.convs:
            b = name[4]
            if block is not None and b != block:
                self.blobs.append('pool' + block)
            self.blobs.append(name)
            block = b
        self.blobs.append('pool' + block)

    def forward(self, x, layers):
        """{layer: tap} for the given blob names (x may require grad)."""
        deepest = max(self.blobs.index(l) for l in layers)
        out, h = {}, x
        if 'data' in layers:
            out['data'] = x
        for i, name in enumerate(self.blobs[:deepest + 1]):
            if name.startswith('conv'):
                w, b = self.weights[name]
                h = F.relu(self.precision.conv(h, w, b))
            else:
                h = F.max_pool2d(h, 2, 2, ceil_mode=True)
            if name in layers:
                out[name] = h
        return out


def preprocess(image_hwc, device, dtype=torch.float32):
    """An HxWx3 RGB image (uint8 or float) -> (1, 3, H, W) in dtype with the
    VGG mean taken off."""
    arr = torch.as_tensor(np.asarray(image_hwc, np.float32),
                          device=device).to(dtype)
    mean = torch.tensor(MEAN_RGB, dtype=dtype, device=device)
    return (arr - mean).permute(2, 0, 1)[None].contiguous()


MEAN_RGB = (123.68, 116.779, 103.939)


def gram(f):
    """(C, C) Gram of a (1, C, H, W) map over C * H * W."""
    c = f.shape[1]
    flat = f.reshape(c, -1)
    return flat @ flat.t() / float(flat.numel())


def rms(t):
    return math.sqrt(float(torch.mean(t.double() ** 2)))


class Objective:
    """The objective at one content, one style target and a norm state."""

    def __init__(self, net, objective, content_x, style_grams, norms=None):
        """objective: the configuration's objective dict; content_x the
        preprocessed content (1, 3, H, W); style_grams {layer: (C, C)}."""
        self.net = net
        self.content_w = {l: float(v) for l, v in
                          objective['content'].items()}
        self.style_w = {l: float(v) for l, v in objective['style'].items()}
        self.scalars = {k: float(objective[k])
                        for k in ('p', 'p_power', 'tv', 'tv_power')}
        taps = set(self.content_w) | set(self.style_w)
        self.layers = [b for b in net.blobs if b in taps]
        with torch.no_grad(), net.precision.scope():
            feats = net.forward(content_x, self.layers)
        self.content = {l: net.precision.tap(feats[l]) for l in self.content_w}
        self.grams = style_grams
        self.norms = {} if norms is None else norms

    def __call__(self, x):
        """(loss as float, input gradient (1, 3, H, W), trace dict)."""
        with self.net.precision.scope():
            return self._evaluate(x)

    def _evaluate(self, x):
        x = x.detach().requires_grad_(True)
        feats = self.net.forward(x, self.layers)
        trace, cot = {}, {}
        scd = torch.zeros((), dtype=x.dtype, device=x.device)
        for layer in self.layers:
            f = self.net.precision.tap(feats[layer].detach())
            size = float(f.numel())
            diff = torch.zeros_like(f)
            if layer in self.content_w:
                cw = self.content_w[layer]
                c_diff = f - self.content[layer]
                c_grad = (2.0 / size) * c_diff
                key = layer + ':c'
                if key not in self.norms:
                    self.norms[key] = torch.sqrt(torch.mean(c_grad ** 2))
                cn = self.norms[key]
                loss = cw * torch.mean(c_diff ** 2) / cn
                trace[layer + '_c_loss'] = float(loss)
                term = cw * c_grad / cn
                trace[layer + '_c_grad'] = rms(term)
                scd = scd + loss
                diff = diff + term
            if layer in self.style_w:
                sw = self.style_w[layer]
                c = f.shape[1]
                gd = gram(f) - self.grams[layer]
                flat = f.reshape(c, -1)
                s_grad = (gd @ flat).reshape(f.shape) * (
                    2.0 / (gd.numel() * flat.numel()))
                key = layer + ':s'
                if key not in self.norms:
                    self.norms[key] = torch.sqrt(torch.mean(s_grad ** 2))
                sn = self.norms[key]
                loss = sw * torch.mean(gd ** 2) / sn
                trace[layer + '_s_loss'] = float(loss)
                term = (sw / sn) * s_grad
                trace[layer + '_s_grad'] = rms(term)
                scd = scd + loss
                diff = diff + term
            cot[layer] = diff
        total = sum((feats[l] * cot[l]).sum() for l in self.layers)
        g_trunk = torch.autograd.grad(total, x)[0]
        xs = x.detach() / 255.0
        t_loss, t_grad = tv_norm(xs, self.scalars['tv_power'])
        p_loss, p_grad = p_norm(xs, self.scalars['p_power'])
        t_term = self.scalars['tv'] * t_grad
        p_term = self.scalars['p'] * p_grad
        t_loss = self.scalars['tv'] * t_loss
        p_loss = self.scalars['p'] * p_loss
        loss = scd + t_loss + p_loss
        grad = g_trunk + t_term + p_term
        trace.update(scd_loss=float(scd), t_loss=float(t_loss),
                     p_loss=float(p_loss), scd_grad=rms(g_trunk),
                     t_grad=rms(t_term), p_grad=rms(p_term),
                     loss=float(loss), grad=rms(grad))
        return float(loss), grad.detach(), trace


def tv_norm(x, beta):
    """TV of (1, 3, H, W) x with circular differences, and its gradient."""
    x_diff = x - torch.roll(x, -1, dims=3)
    y_diff = x - torch.roll(x, -1, dims=2)
    gn2 = x_diff ** 2 + y_diff ** 2 + 1e-8
    norm = torch.sum(gn2 ** (beta / 2))
    dgn = (beta / 2) * gn2 ** (beta / 2 - 1)
    dx, dy = 2 * x_diff * dgn, 2 * y_diff * dgn
    grad = dx + dy - torch.roll(dx, 1, dims=3) - torch.roll(dy, 1, dims=2)
    return norm, grad


def p_norm(x, p):
    return (torch.sum(torch.abs(x) ** p) / p,
            torch.sign(x) * torch.abs(x) ** (p - 1))


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


class LBFGS:
    """Fixed-step L-BFGS with no line search (the original optimizers.py):
    pairs with s.y <= 1e-10 are rejected; an empty history RMS-normalizes
    the direction, else it is scaled by s.y / y.y of the newest pair."""

    def __init__(self, x, opfunc, step_size=1.0, n_corr=10, history=(),
                 loss=None, grad=None):
        """history: [(s, y), ...] oldest first (a state to follow from)."""
        self.x = x
        self.opfunc = opfunc
        self.step_size = step_size
        self.n_corr = n_corr
        self.hist = [(s, y, _dot(s, y)) for s, y in history]
        self.loss, self.grad = loss, grad
        self.traces = []

    def prime(self):
        self.loss, self.grad, trace = self.opfunc(self.x)
        self.traces.append(trace)
        return trace

    def step(self):
        if self.grad is None:
            self.prime()
        s = -self.step_size * self.inv_hv(self.grad.clone())
        self.x = self.x + s
        loss, grad, trace = self.opfunc(self.x)
        y = grad - self.grad
        sy = _dot(s, y)
        if float(sy) > 1e-10:
            self.hist.append((s, y, sy))
            self.hist = self.hist[-self.n_corr:]
        self.loss, self.grad = loss, grad
        self.traces.append(trace)
        return trace

    def inv_hv(self, p):
        alphas = []
        for s, y, sy in reversed(self.hist):
            alphas.append(_dot(s, p) / sy)
            p = p - alphas[-1] * y
        if self.hist:
            s, y, sy = self.hist[-1]
            p = p * (sy / _dot(y, y))
        else:
            p = p / torch.sqrt(_dot(p, p) / p.numel())
        for (s, y, sy), alpha in zip(self.hist, reversed(alphas)):
            beta = _dot(y, p) / sy
            p = p + (alpha - beta) * s
        return p


def _lanczos3(d):
    d = np.abs(d)
    out = np.ones_like(d)
    nz = d > 1e-3
    pd = np.pi * d[nz]
    out[nz] = 3.0 * np.sin(pd) * np.sin(pd / 3.0) / (pd * pd)
    out[d > 3.0] = 0.0
    return out


def _lanczos_matrix(n_in, n_out):
    """(n_out, n_in) antialiased lanczos3 resampling weights with
    half-pixel centres, each row summing to 1 (float64)."""
    scale = n_out / n_in
    kscale = max(1.0 / scale, 1.0)
    centres = (np.arange(n_out) + 0.5) / scale - 0.5
    d = (centres[:, None] - np.arange(n_in)[None, :]) / kscale
    w = _lanczos3(d)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centres >= -0.5) & (centres <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


def resize_lanczos3(x, hw, dtype=torch.float64):
    """(1, C, H, W) -> (1, C, *hw) by separable antialiased lanczos3, each
    axis whose size changes, computed in dtype."""
    out = x.to(dtype)
    h, w = x.shape[2:]
    if hw[0] != h:
        m = torch.as_tensor(_lanczos_matrix(h, hw[0]), device=x.device,
                            dtype=dtype)
        out = torch.einsum('oh,nchw->ncow', m, out)
    if hw[1] != w:
        m = torch.as_tensor(_lanczos_matrix(w, hw[1]), device=x.device,
                            dtype=dtype)
        out = torch.einsum('pw,nchw->nchp', m, out)
    return out.float().contiguous()


class Reference:
    """The reference (or, at a lower precision, a control) for one
    configuration and one set of weights."""

    def __init__(self, config, weights, precision='float32'):
        """weights: {conv name: (w HWIO float32 tensor, b)} on the device
        the reference runs on; they are laid out NCHW here, in the
        precision's dtype."""
        self.config = config
        self.precision = Precision(precision)
        dtype = self.precision.dtype
        self.net = VGG(config['convs'], {
            name: (w.permute(3, 2, 0, 1).contiguous().to(dtype), b.to(dtype))
            for name, (w, b) in weights.items()}, self.precision)
        self.device = next(iter(weights.values()))[0].device
        self.style_grams = None

    def preprocess(self, image_hwc):
        return preprocess(image_hwc, self.device, self.precision.dtype)

    def set_style(self, style_hwc):
        x = self.preprocess(style_hwc)
        layers = list(self.config['objective']['style'])
        with torch.no_grad(), self.precision.scope():
            feats = self.net.forward(x, layers)
        self.style_grams = {l: gram(self.precision.tap(f))
                            for l, f in feats.items()}

    def objective(self, content_hwc, norms=None):
        return Objective(self.net, self.config['objective'],
                         self.preprocess(content_hwc), self.style_grams,
                         norms)

    def resize(self, x, hw):
        """The warm start of a ladder's next rung: x resized to hw (float64
        in the reference; the controls in their own precision)."""
        if self.precision.name == 'float32':
            return resize_lanczos3(x, hw)
        with self.precision.scope():
            return resize_lanczos3(self.precision.tap(x), hw, torch.float32)

    def lbfgs(self, x, opfunc, **kw):
        opt = self.config['optimizer']
        return LBFGS(x, opfunc, step_size=float(opt['step_size']),
                     n_corr=int(opt['n_corr']), **kw)
