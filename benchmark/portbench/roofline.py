"""The yardstick's frozen counts and peaks: what one evaluation of the Gatys
objective on VGG-19 needs, from shapes alone, and the H100's data-sheet peaks.

The counts are of the work the step needs, never of what a kernel does, and
read nothing of the program (no planner, no route, no padding), so a change of
route moves no count:
  * a 3x3 conv is 2 * 9 * Cin * Cout FLOPs an output pixel, once forward and
    once for the input gradient (no weight gradients in this workload);
  * the style branch of a tap of M pixels and C channels is the symmetric
    Gram, M * C * (C + 1), and the gradient product, 2 * M * C^2; the model
    FLOPs of a step count the Gram in full (2 * 2 * M * C^2 a tap), as the
    program's own roofline (utils/perfmodel.py model_step) counts them;
  * bytes: each input of a kernel read once and each output written once.
A kernel's bound is the larger of its FLOPs over the peak of the unit that
would run it at the configuration's precision and its bytes over the memory
rate. Since these are floors, a share of them cannot pass 100% unless the
measured time leaves out part of the work.
"""

# NVIDIA H100 SXM data sheet, dense, at 700 W.
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
HBM_BYTES_S = 3.35e12
DTYPE_BYTES = {'float32': 4, 'bfloat16': 2}


def blobs(convs):
    """Blob names in forward order for [(conv, cin, cout), ...]: each
    block's convs, then its pool."""
    out, block = [], None
    for name, _, _ in convs:
        if block is not None and name[4] != block:
            out.append('pool' + block)
        out.append(name)
        block = name[4]
    out.append('pool' + block)
    return out


def walk(hw, convs, deepest):
    """Yields (conv name, h, w, cin, cout) of every conv up to the blob
    `deepest`, on its grid (2x2 pools in ceil mode)."""
    spec = {name: (cin, cout) for name, cin, cout in convs}
    h, w = hw
    for name in blobs(convs):
        if name.startswith('conv'):
            yield (name, h, w) + spec[name]
        else:
            h, w = -(-h // 2), -(-w // 2)
        if name == deepest:
            return


def tap_grid(hw, convs, layer):
    for name, h, w, _, cout in walk(hw, convs, layer):
        if name == layer:
            return h * w, cout
    raise ValueError('no conv %s' % layer)


def deepest(convs, layers):
    order = blobs(convs)
    return max(layers, key=order.index)


def eval_flops(hw, convs, content, style):
    """Model FLOPs of one evaluation (forward, input gradient, Gram and
    gradient product at every style tap)."""
    last = deepest(convs, list(content) + list(style))
    flops = sum(2.0 * 2 * h * w * 9 * cin * cout
                for _, h, w, cin, cout in walk(hw, convs, last))
    for layer in style:
        m, c = tap_grid(hw, convs, layer)
        flops += 2 * 2.0 * m * c * c
    return flops


def forward_flops(hw, convs, last):
    """FLOPs of a forward pass to the blob `last` (a content or style
    image's features)."""
    return sum(2.0 * h * w * 9 * cin * cout
               for _, h, w, cin, cout in walk(hw, convs, last))


def _bound(flops, nbytes, precision):
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_S)


def conv_bound_s(hw, convs, last, precision, backward=True, lanes=1):
    """Least seconds for the convs of a forward to `last` over `lanes`
    images at once, and of their input gradients when backward: each conv
    direction on its own bound, its weights read once for all the lanes."""
    b = DTYPE_BYTES[precision]
    total = 0.0
    for _, h, w, cin, cout in walk(hw, convs, last):
        px = lanes * h * w
        flops = 2.0 * 9 * px * cin * cout
        total += _bound(flops, b * (px * (cin + cout) + 9 * cin * cout),
                        precision)
        if backward:
            total += _bound(flops, b * (px * (2 * cout + cin)
                                        + 9 * cin * cout), precision)
    return total


def style_bound_s(hw, convs, style, precision):
    """Least seconds for the style branch at every style tap: the symmetric
    Gram and the gradient product, the tap read once, the style Gram read
    once (float32), the gradient written once."""
    b = DTYPE_BYTES[precision]
    total = 0.0
    for layer in style:
        m, c = tap_grid(hw, convs, layer)
        flops = m * c * (c + 1) + 2.0 * m * c * c
        total += _bound(flops, 2 * b * m * c + 4 * c * c, precision)
    return total
