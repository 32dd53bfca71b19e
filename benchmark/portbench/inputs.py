"""What a run is given: the weights, the images and the random starts, all
made here from --seed so that the program and the reference get the same.

The weights are He-normal (std sqrt(2 / (9 Cin)), biases 0), drawn on the run's
device by one torch.Generator in one call for all the convolutions of the
configuration. The images are the two JPEGs beside this package, resized with
PIL's LANCZOS as the CLI resizes them. Each job's random start is a uint8
image from a numpy generator keyed by (seed, job), so a job can be made again
after the window without keeping it.
"""

from pathlib import Path

import numpy as np
import torch
from PIL import Image

IMAGES = Path(__file__).resolve().parents[1] / 'images'

# Sub-streams of a seed: which generator a draw belongs to.
_WEIGHTS, _STARTS = 1, 2


def _seed_words(seed):
    """A seed of any size as 32-bit words for numpy's SeedSequence."""
    seed = int(seed)
    if seed < 0:
        raise ValueError('--seed must be >= 0')
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def torch_seed(seed, stream):
    """A 63-bit torch seed for one sub-stream of --seed."""
    a, b = np.random.SeedSequence(_seed_words(seed) + [stream]) \
        .generate_state(2, np.uint32)
    return ((int(a) << 31) ^ int(b)) & ((1 << 63) - 1)


def make_weights(convs, seed, device):
    """{conv name: (w HWIO float32, b float32)} on device, He-normal."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, _WEIGHTS))
    sizes = [9 * cin * cout for _, cin, cout in convs]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, cin, cout), n in zip(convs, sizes):
        std = float(np.sqrt(2.0 / (9 * cin)))
        w = flat[at:at + n].view(3, 3, cin, cout) * std
        out[name] = (w, torch.zeros(cout, dtype=torch.float32, device=device))
        at += n
    return out


def as_params(weights):
    """The weights as the program's params dict of HWIO numpy arrays."""
    return {name: {'w': w.cpu().numpy(), 'b': b.cpu().numpy()}
            for name, (w, b) in weights.items()}


def load_image(name):
    """An RGB PIL image by name: 'golden_gate', 'starry_night'."""
    with Image.open(IMAGES / (name + '.jpg')) as img:
        return img.convert('RGB')


def fit_into_square(wh, size):
    """The aspect-kept (w, h) of an image scaled to fit a size-square."""
    w, h = wh
    if w > h:
        return size, int(round(size * h / w))
    return int(round(size * w / h)), size


def fit(img, hw):
    """A PIL image resized (LANCZOS) to an (h, w) grid, as uint8 HxWx3."""
    return np.asarray(img.resize((hw[1], hw[0]), Image.LANCZOS),
                      dtype=np.uint8).copy()


def style_image(name, size):
    img = load_image(name)
    w, h = fit_into_square(img.size, size)
    return fit(img, (h, w))


def random_start(seed, job, hw):
    """Job `job`'s random start, an (h, w, 3) uint8 RGB image uniform over
    0-255 (the CLI's --init random), from (seed, job)."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(_seed_words(seed) + [_STARTS, int(job)])))
    return rng.integers(0, 256, size=tuple(hw) + (3,), dtype=np.uint8)
