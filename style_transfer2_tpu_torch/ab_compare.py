"""Compares chip_smoke.py runs of two trees row by row.

    python -m style_transfer2_tpu_torch.ab_compare \\
        --tree a/kernels.json b/kernels.json \\
        --parent c/kernels.json d/kernels.json [--limit 1.03]

Each kernels.json is the one chip_smoke.py writes to its OUT_DIR. For
every row (kernel, dtype, where, shape) and each time in it (the
launch-inclusive conv fwd_ms and bwd_ms, the style branch's ms, the image
kernels' preprocess_ms and deprocess_ms; each kernel's device_ms from the
profile phase, and its host_us), the tree's mean over its runs is divided
by the parent's. Prints one JSON line per group of rows (kernel, dtype and
field) with its row count, the worst and median ratio, the rows above
--limit and the group's sums over its rows in both trees (rows where a run
did not measure the field are left out of the group), then the float32
and bfloat16 conv times summed over one step of each iterate size for
both trees.
Reads files only: run the trees in one call on one card, in turns (tree,
parent, parent, tree).
"""

import argparse
import json
import statistics
import sys

from .split_sweep import trunk_convs

FIELDS = {'conv3x3': ('fwd_ms', 'bwd_ms', 'fwd_device_ms', 'bwd_device_ms',
                      'fwd_host_us', 'bwd_host_us'),
          'fused_style_branch': ('ms', 'device_ms', 'host_us'),
          'image': ('preprocess_ms', 'deprocess_ms', 'preprocess_device_ms',
                    'deprocess_device_ms', 'preprocess_host_us',
                    'deprocess_host_us')}
# What step_sums adds up over one step's conv rows.
STEP_FIELDS = ('fwd_ms', 'bwd_ms', 'fwd_library_ms', 'fwd_device_ms',
               'bwd_device_ms', 'fwd_library_device_ms',
               'bwd_library_device_ms', 'fwd_host_us', 'bwd_host_us')
# The iterate sizes chip_smoke.py sums over one step (its STEP_SIZES), by
# the `where` of their rows.
STEP_SIZES = {'512': (384, 512), '543x724': (543, 724), '1024': (768, 1024)}


def load(paths):
    """{(kernel, dtype, where, shape): [row of each run]}."""
    rows = {}
    for path in paths:
        with open(path) as f:
            for row in json.load(f):
                key = (row['kernel'], row['dtype'], row.get('where', ''),
                       tuple(row['shape']))
                rows.setdefault(key, []).append(row)
    return rows


def mean(rows, field):
    """The mean of a field over the runs, or None where a run lacks it."""
    values = [r.get(field) for r in rows]
    return None if None in values else statistics.fmean(values)


def compare(tree, parent, limit):
    """One dict per (kernel, dtype, field) group."""
    groups = {}
    for key, runs in tree.items():
        if key not in parent:
            continue
        kernel, dtype, where, shape = key
        for field in FIELDS[kernel]:
            mine, theirs = mean(runs, field), mean(parent[key], field)
            if mine is None or theirs is None:
                continue
            groups.setdefault((kernel, dtype, field), []).append(
                (mine / theirs, where, shape, mine, theirs))
    out = []
    for (kernel, dtype, field), ratios in sorted(groups.items()):
        values = [r[0] for r in ratios]
        tree_sum = sum(r[3] for r in ratios)
        parent_sum = sum(r[4] for r in ratios)
        out.append({'kernel': kernel, 'dtype': dtype, 'field': field,
                    'rows': len(values), 'worst': max(values),
                    'median': statistics.median(values),
                    'tree_sum': tree_sum, 'parent_sum': parent_sum,
                    'sum_ratio': tree_sum / parent_sum,
                    'above_limit': [[where, list(shape), r]
                                    for r, where, shape, _, _ in sorted(
                                        ratios) if r > limit]})
    return out


def step_sums(rows):
    """{dtype: {size: {field: ms}}}: each run's conv times summed over one
    step, as [min, max] over the runs; None for a field some row of a run
    lacks."""
    sums = {}
    for dtype in ('float32', 'bfloat16'):
        for where, hw in STEP_SIZES.items():
            per_run = None
            for shape in trunk_convs(*hw):
                runs = rows.get(('conv3x3', dtype, where, shape))
                if runs is None:
                    per_run = None
                    break
                if per_run is None:
                    per_run = [dict.fromkeys(STEP_FIELDS, 0.0)
                               for _ in runs]
                for total, row in zip(per_run, runs):
                    for field in STEP_FIELDS:
                        value = row.get(field)
                        total[field] = (None if value is None
                                        or total[field] is None
                                        else total[field] + value)
            if per_run:
                sums.setdefault(dtype, {})[where] = {
                    field: (None if any(t[field] is None for t in per_run)
                            else [min(t[field] for t in per_run),
                                  max(t[field] for t in per_run)])
                    for field in STEP_FIELDS}
    return sums


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--tree', nargs='+', required=True)
    p.add_argument('--parent', nargs='+', required=True)
    p.add_argument('--limit', type=float, default=1.03)
    args = p.parse_args(argv)
    tree, parent = load(args.tree), load(args.parent)
    for group in compare(tree, parent, args.limit):
        print(json.dumps(group))
    print(json.dumps({'step_sums': {'tree': step_sums(tree),
                                    'parent': step_sums(parent)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
