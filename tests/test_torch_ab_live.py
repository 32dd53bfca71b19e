"""ab_live's pieces that need no card: a checkout imported under another
package name, the sides taken in turns, and the sums by group and round."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from style_transfer2_tpu_torch import ab_live
from style_transfer2_tpu_torch.ops import conv

ROOT = Path(__file__).resolve().parents[1]


def test_load_imports_a_checkout_apart_from_the_package():
    try:
        ops = ab_live.load(ROOT, 'st2_copy_under_test')
        assert ops['conv'] is not conv
        assert ops['conv'].__name__ == 'st2_copy_under_test.ops.conv'
        assert ops['_build']._lib is None          # nothing built
        rng = np.random.RandomState(0)
        x = torch.from_numpy(np.float32(rng.randn(1, 5, 6, 8)))
        w = torch.from_numpy(np.float32(rng.randn(3, 3, 8, 16) * 0.1))
        b = torch.from_numpy(np.float32(rng.randn(16)))
        assert torch.equal(ops['conv'].conv3x3_bias_relu_plain(x, w, b),
                           conv.conv3x3_bias_relu_plain(x, w, b))
    finally:
        for name in [m for m in sys.modules
                     if m.split('.')[0] == 'st2_copy_under_test']:
            del sys.modules[name]


@pytest.mark.parametrize('rounds', [1, 2, 3])
def test_measure_takes_each_call_on_both_sides_in_turns(rounds):
    order = []
    sides = {side: {('g', 'a'): (side, 'a'), ('skip', 'b'): (side, 'b'),
                    ('g', 'c'): (side, 'c')} for side in ('this', 'other')}
    got = ab_live.measure(sides, lambda fn: order.append(fn) or len(order),
                          rounds, lambda group: group == 'g')
    turns = [('this', 'a'), ('other', 'a'), ('other', 'c'), ('this', 'c'),
             ('other', 'a'), ('this', 'a'), ('this', 'c'), ('other', 'c')]
    assert order == (turns * 2)[:4 * rounds]
    assert sorted(got['this']) == [('g', 'a'), ('g', 'c')]
    assert len(got['other'][('g', 'a')]) == rounds


def test_group_sums_leave_a_round_with_a_missing_call_unsummed():
    got = {'this': {('g', 'a'): [1.0, 2.0, None], ('g', 'b'): [3.0, 4.0, 5.0],
                    ('h', 'a'): [1.0, 1.0, 1.0]},
           'other': {('g', 'a'): [2.0, 2.0, 2.0], ('g', 'b'): [2.0, 2.0, 2.0],
                     ('h', 'a'): [2.0, None, 2.0]}}
    sums = ab_live.group_sums(got, 3)
    assert sums == {'g': {'this': [4.0, 6.0, None], 'other': [4.0] * 3},
                    'h': {'this': [1.0] * 3, 'other': [2.0, None, 2.0]}}
    summary = ab_live.summarize(sums)
    assert summary['g']['median'] == {'this': None, 'other': 4.0}
    assert summary['g']['ratio'] is None
    del sums['g']['this'][2]
    assert ab_live.summarize(sums)['g']['ratio'] == 5.0 / 4.0
    assert ab_live.summarize(sums)['h']['ratio'] is None
