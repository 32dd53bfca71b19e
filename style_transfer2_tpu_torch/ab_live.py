"""Times this checkout's kernels beside another checkout's, in one process
and with one yardstick.

    python -m style_transfer2_tpu_torch.ab_live build/parent \\
        [--host-rounds 6] [--device-rounds 2] [--only style]

Run from the repository root on a machine with a card (it takes
chip_smoke.py's host_us and device_ms). The other checkout, a `git
archive` of the parent say, is imported under another package name and
builds its own kernels into its own build/. Both packages' wrappers are
called on the same inputs, each call on both sides back to back in turns
(this, other, other, this, ...), so that drift falls on both alike:

  host_us   — the bfloat16 conv wrappers, forward and backward on their
              planned paths, summed over one step's calls at the 512px and
              768x1024 iterates. Taken first: a profiler session slows
              torch's host path for the rest of the process.
  device_ms — summed by group: the conv forward and backward in float32
              and bfloat16 over the same steps, the style branch at those
              iterates' taps, and preprocess (uint8) and deprocess over
              the 7 rungs of the 1024px ladder. Two profiler sessions that
              saw the most kernels must agree, as in chip_smoke.py; a
              group with a call not measured has no sum in that round.

--only GROUP times just the groups whose name holds GROUP, host_us and
device_ms both (the style branch's host_us, say, which the default
leaves out).

Prints one JSON line: for each group, each side's sums by round, their
medians and the ratio of the medians (this / other). The same, call by
call, goes to chiprun_out/ab_live.json.
"""

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
STEPS = {'512': (384, 512), '1024': (768, 1024)}
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def load(root, name):
    """The ops modules and _build of the port in checkout `root`, imported
    as package `name`. Nothing is built here."""
    pkg = Path(root).resolve() / 'style_transfer2_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        name, pkg / '__init__.py', submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    ops = {m: importlib.import_module('%s.ops.%s' % (name, m))
           for m in ('conv', 'style', 'image')}
    ops['_build'] = importlib.import_module(name + '._build')
    return ops


def calls(ops, cases):
    """{(group, call name): fn} of one side on the shared inputs."""
    conv, style, image = ops['conv'], ops['style'], ops['image']
    out = {}
    for (dtype, where, i, shape), (x, w, b, g, y) in cases['conv'].items():
        wb = conv.backward_weights(w)
        name = 'conv%d %s' % (i + 1, shape)
        out[('conv fwd %s %s' % (dtype, where), name)] = (
            lambda x=x, w=w, b=b: conv._launch_fwd(x, w, b))
        out[('conv bwd %s %s' % (dtype, where), name)] = (
            lambda g=g, y=y, wb=wb: conv._launch_bwd(g, y, wb))
    for (where, tap), (feat, gram) in cases['style'].items():
        out[('style ' + where, str(tap))] = (
            lambda f=feat, s=gram: style._launch(f, s))
    for hw, (src, x) in cases['image'].items():
        out[('preprocess', str(hw))] = (
            lambda s=src: image._launch_preprocess(s))
        out[('deprocess', str(hw))] = lambda x=x: image._launch_deprocess(x)
    return out


def inputs(chip_smoke, dev, seed=0):
    """The inputs both sides are timed on, made once."""
    rng = np.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.float32(a), device=dev).to(dtype)

    cases = {'conv': {}, 'style': {}, 'image': {}}
    for name, dtype in DTYPES.items():
        for where, hw in STEPS.items():
            # Every conv of the step, a shape run three times three times.
            for i, (h, w, cin, cout) in enumerate(
                    chip_smoke.trunk_convs(*hw)):
                cases['conv'][(name, where, i, (h, w, cin, cout))] = (
                    t(rng.randn(1, h, w, cin), dtype),
                    t(rng.normal(0, np.sqrt(2 / (9 * cin)),
                                 (3, 3, cin, cout)), dtype),
                    t(rng.randn(cout) * 0.1, dtype),
                    t(rng.randn(1, h, w, cout), dtype),
                    t(np.maximum(rng.randn(1, h, w, cout), 0), dtype))
    for where, hw in STEPS.items():
        for h, w, c in chip_smoke.style_taps(*hw):
            feat = t(np.maximum(rng.randn(1, h, w, c), 0))
            flat = feat.reshape(-1, c)
            cases['style'][(where, (h, w, c))] = (
                feat, flat.T @ flat / flat.numel())
    for hw in chip_smoke.LADDER_1024:
        cases['image'][hw] = (
            torch.from_numpy(rng.randint(0, 256, hw + (3,)).astype(
                np.uint8)).to(dev),
            t(rng.uniform(-120, 150, (1,) + hw + (3,))))
    return cases


def keeps(only=''):
    """(host keep, device keep): which groups each measurement takes. By
    default the bfloat16 conv groups' host_us and every group's device_ms;
    with `only`, the groups whose name holds it, in both."""
    if only:
        return (lambda g: only in g), (lambda g: only in g)
    return (lambda g: 'bfloat16' in g), (lambda g: True)


def measure(sides, measure_fn, rounds, keep):
    """{side: {(group, call): [value by round]}}, only the calls whose group
    passes keep(group). Each call is taken on both sides back to back, in
    turns (a, b, b, a, ...), so that what slows the host for a while falls
    on both alike."""
    names = list(sides)
    got = {name: {} for name in names}
    keys = [key for key in sides[names[0]] if keep(key[0])]
    for r in range(rounds):
        for i, key in enumerate(keys):
            for name in (names if (r + i) % 2 == 0 else names[::-1]):
                got[name].setdefault(key, []).append(
                    measure_fn(sides[name][key]))
    return got


def group_sums(got, rounds):
    """{group: {side: [sum by round, None where a call was not
    measured]}}."""
    out = {}
    for side, values in got.items():
        for (group, _), by_round in values.items():
            sums = out.setdefault(group, {}).setdefault(side, [0.0] * rounds)
            for r, v in enumerate(by_round):
                sums[r] = None if v is None or sums[r] is None else sums[r] + v
    return out


def summarize(sums):
    """Each group's sums, their medians and this / other."""
    out = {}
    for group, by_side in sorted(sums.items()):
        medians = {side: (statistics.median(v) if None not in v else None)
                   for side, v in by_side.items()}
        this, other = medians['this'], medians['other']
        out[group] = {'this': by_side['this'], 'other': by_side['other'],
                      'median': medians,
                      'ratio': None if None in (this, other)
                      else this / other}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('other', help='root of the other checkout')
    p.add_argument('--host-rounds', type=int, default=6)
    p.add_argument('--device-rounds', type=int, default=2)
    p.add_argument('--only', default='',
                   help='time only the groups whose name holds this')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('ab_live needs CUDA')
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from . import utils
    dev = torch.device('cuda')
    cases = inputs(chip_smoke, dev)
    this, other = load(ROOT, 'st2_this'), load(args.other, 'st2_other')
    for ops in (this, other):
        ops['_build'].lib()
    sides = {'this': calls(this, cases), 'other': calls(other, cases)}
    for fns in sides.values():
        for fn in fns.values():
            fn()                                        # warm-up
    torch.cuda.synchronize()

    host_keep, device_keep = keeps(args.only)
    with utils.tf32(False):
        host = measure(sides, lambda fn: chip_smoke.host_us(fn, torch),
                       args.host_rounds, host_keep)
        os.environ['TEARDOWN_CUPTI'] = '0'     # as chip_smoke.phase_costs
        device = measure(sides, lambda fn: chip_smoke.device_ms(fn, torch),
                         args.device_rounds, device_keep)
    result = {
        'card': subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
        'other': str(args.other),
        'host_us': summarize(group_sums(host, args.host_rounds)),
        'device_ms': summarize(group_sums(device, args.device_rounds)),
        'host_rounds': args.host_rounds,
        'device_rounds': args.device_rounds}
    out_dir = ROOT / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    (out_dir / 'ab_live.json').write_text(json.dumps(
        {'summary': result, 'calls': {
            kind: {side: {'%s %s' % key: v for key, v in values.items()}
                   for side, values in got.items()}
            for kind, got in (('host_us', host), ('device_ms', device))}},
        indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
