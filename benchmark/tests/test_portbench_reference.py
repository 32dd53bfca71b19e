"""The plain reference against the port's CPU engine at a tiny size, in both
configurations: the start of a job, the gradient at the engine's own state and
one L-BFGS step from it, and the lanczos3 resample of a rung switch (CPU)."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from portbench import check, core  # noqa: E402
from portbench.driver import Driver  # noqa: E402

# What the CPU engine's plain versions give beside the float32 reference at
# 48x64 (measured: float32 under 3e-6; bfloat16, whose loss feed rounds
# every tap to 8 bits of mantissa, 1e-2 to 4e-2 at these small grids).
TOL = {'vgg19-gatys-f32': {'start_loss_gap': 1e-4, 'start_grad_gap': 1e-4,
                           'start_step_gap': 1e-4},
       'vgg19-gatys-bf16': {'start_loss_gap': 0.15, 'start_grad_gap': 0.15,
                            'start_step_gap': 0.05}}


@pytest.mark.parametrize('config_name', sorted(TOL))
def test_reference_follows_the_cpu_engine(config_name):
    torch.manual_seed(0)
    torch.set_num_threads(2)
    config = core.load_json(BENCH / 'configs' / (config_name + '.json'))
    traffic = core.load_json(BENCH / 'traffic' / '1024-ladder.json')
    traffic = dict(traffic, rungs=[[48, 64], [68, 91]], iterations=4,
                   chunk=2, style_size=64)
    d = Driver(traffic, config, 2 ** 31 + 3, torch.device('cpu'),
               core.program_modules())
    d.build()
    warm = d.warm_job()
    d.run_job(d.next_job, float('inf'))
    d.next_job += 1
    follow = d.follow()
    out, n = core.compare(core.reference_module(config), config, d, warm,
                          follow, d.answers)
    assert n == 1
    for name, tol in TOL[config_name].items():
        assert out.values[name] < tol, (name, out.values[name], out.where)
    # One L-BFGS step from the engine's state, the two-loop's arithmetic
    # alone, and the resample: float32 in both configurations.
    assert out.values['follow_step_gap'] < 1e-5, out.where
    # The gradient a replay gave at the window's last iterate.
    assert out.values['follow_grad_gap'] < TOL[config_name]['start_grad_gap']
    assert out.values['input_gap'] < 1e-5, out.where
    assert out.values['answer_loss_gap'] < TOL[config_name]['start_loss_gap']


def test_resample_against_the_ports():
    from style_transfer2_tpu_torch.ops.resample import resize_nhwc
    ref = core.reference_module({'reference': 'vgg19_gatys'})
    x = torch.randn(1, 40, 52, 3) * 100
    for hw in ((57, 74), (28, 37), (40, 74)):
        port = resize_nhwc(x, hw, 'lanczos3')
        mine = ref.resize_lanczos3(check.nchw(x), hw).permute(0, 2, 3, 1)
        gap = float((port - mine).norm() / mine.norm())
        # The port's float32 weights and sums against float64: 1.5e-6.
        assert gap < 1e-5, (hw, gap)
