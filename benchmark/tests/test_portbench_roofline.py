"""The frozen counts against the program's own roofline model at every
cell's shapes on this commit (CPU)."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from portbench import core, roofline  # noqa: E402
from style_transfer2_tpu_torch.utils import perfmodel  # noqa: E402

SPEC = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
GRIDS = sorted({(w['name'], tuple(hw)) for w in SPEC['workloads']
                for hw in core.cell_parts(w['name'])[3]['rungs']})


@pytest.mark.parametrize('cell,hw', GRIDS)
def test_frozen_step_flops_equal_the_programs_model(cell, hw):
    _, _, config, traffic, _ = core.cell_parts(cell)
    obj = config['objective']
    lanes = int(traffic.get('lanes', 1))
    frozen = lanes * roofline.eval_flops(hw, config['convs'],
                                         list(obj['content']),
                                         list(obj['style']))
    model = perfmodel.model_step(hw, config['precision'],
                                 content_layers=tuple(obj['content']),
                                 style_layers=tuple(obj['style']))
    assert frozen == model.lanes(lanes).flops


def test_bounds_are_floors():
    convs = json.loads((BENCH / 'configs' / 'vgg19-gatys-bf16.json')
                       .read_text())['convs']
    hw = (384, 512)
    one = roofline.conv_bound_s(hw, convs, 'conv4_2', 'bfloat16')
    four = roofline.conv_bound_s(hw, convs, 'conv4_2', 'bfloat16', lanes=4)
    # Four lanes read the weights once: never more than four images alone.
    assert one < four <= 4 * one
    f32 = roofline.conv_bound_s(hw, convs, 'conv4_2', 'float32')
    assert f32 == pytest.approx(
        2 * roofline.forward_flops(hw, convs, 'conv4_2') / 67e12, rel=0.05)
