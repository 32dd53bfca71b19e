"""Batched lanes: concurrent jobs as the batch dimension of one step
(style_transfer2_tpu/parallel/). The JAX package's mesh helpers and its
DataPlacement, which shard lanes and grids over several chips, are not
ported: the port runs on one GPU."""

from .batch import (build_batched_step_fns, build_masked_batched_prime_fn,
                    build_masked_batched_scan_fn,
                    build_masked_batched_step_fns, stack_lanes,
                    unstack_lane)

__all__ = ['build_batched_step_fns', 'build_masked_batched_prime_fn',
           'build_masked_batched_scan_fn', 'build_masked_batched_step_fns',
           'stack_lanes', 'unstack_lane']
