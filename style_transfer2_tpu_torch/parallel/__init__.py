"""Parallelism (style_transfer2_tpu/parallel/): device meshes, spatial
sharding of one image over a mesh axis, and batched lanes, whose lane axis
may split over a mesh's 'data' axis.

  * mesh.py — make_mesh, a grid of torch.devices with named axes;
  * spatial.py — SpatialPlacement: one high-resolution image's H axis (W
    where H does not divide) cut into per-device shards (Sharded), with
    the halo exchange, cross-shard sums and gathers the trunk, the losses
    and the optimizers need;
  * batch.py — concurrent jobs as lanes of one batched step, and
    DataPlacement, which gives each device of the 'data' axis a group of
    the lanes.

batch.py's names are loaded at their first use: it imports the engine,
whose kernels' wrappers import spatial.py.
"""

from .mesh import Mesh, make_mesh
from .spatial import Sharded, SpatialPlacement

_BATCH = ('DataPlacement', 'build_batched_step_fns',
          'build_masked_batched_prime_fn', 'build_masked_batched_scan_fn',
          'build_masked_batched_step_fns', 'stack_lanes', 'unstack_lane')

__all__ = ['Mesh', 'make_mesh', 'Sharded', 'SpatialPlacement'] + list(_BATCH)


def __getattr__(name):
    if name in _BATCH:
        from . import batch
        return getattr(batch, name)
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
