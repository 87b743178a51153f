"""MSM with its points sharded over a mesh of devices (the port of the JAX
package's msm/distributed.py).

Window totals are additive over point shards: every shard runs the
sort-based bucket accumulation (msm/sorted.py `window_totals`: the bucket
scan and the point kernels) over its own points, the per-window totals are
gathered to the mesh's first device and reduced axis by axis, innermost
first, with the tree of point additions, and ONE Horner pass combines the
windows of every column.  Only W window points a column and shard move.

Totals add over shards only if every shard cuts its scalars into the same
windows: the window width c, the scan block and the window group come from
the shard's point count n/D, the same on every shard, and each shard pads
its points as `msm_many` pads them.
"""

from __future__ import annotations

import torch

from halo2_tpu_torch.msm import sorted as msm_sorted
from halo2_tpu_torch.msm.msm import (_block_for, _combine_windows,
                                     column_totals, window_bits_for)
from halo2_tpu_torch.utils import mesh as mesh_mod


def msm_many_sharded(points, scalar_columns, mesh, axis="x",
                     max_bits=None):
    """`msm_many` with the points and scalars sharded over `axis` (a mesh
    axis name, or a tuple of names outermost first): points (x, y) each
    (16, n) whole on any device, or already as lists of row shards, one
    on each device (Params keeps its bases so); the scalar columns
    (16, n) whole on any device.  n must split evenly over the devices
    and each axis size be a power of two.  Returns projective (X, Y, Z)
    limbs, each (16, C), on the first device."""
    px, py = points
    whole = isinstance(px, torch.Tensor)
    n = px.shape[1] if whole else sum(x.shape[1] for x in px)
    axes = mesh.axes(axis)
    for ax in axes:
        if mesh.shape[ax] & (mesh.shape[ax] - 1):
            raise ValueError(f"mesh axis {ax!r} size must be a power of two")
    devices = mesh.devices_of(axes)
    D = len(devices)
    if n % D:
        raise ValueError("points must divide evenly across devices")
    if not scalar_columns:
        raise ValueError("msm_many needs at least one column")
    bits = list(max_bits) if max_bits is not None \
        else [256] * len(scalar_columns)
    if len(bits) != len(scalar_columns):
        raise ValueError("one max_bits entry per column")
    block = _block_for(n // D)
    # every shard has n/D points, so every shard cuts a column into the
    # same windows; its totals stay on its device until the gather
    if whole:
        xs = mesh_mod.scatter(px, devices)
        ys = mesh_mod.scatter(py, devices)
    else:
        xs, ys = list(px), list(py)
        if len(xs) != D or any(x.shape[1] != n // D for x in xs):
            raise ValueError("one shard of n/D points on each device")
    cols = [mesh_mod.scatter(s, devices) for s in scalar_columns]
    per_shard = [column_totals(xs[d], ys[d], [c[d] for c in cols], bits,
                               block) for d in range(D)]
    # the shards' totals gathered to the first device: (16, C, W, D)
    totals = [mesh_mod.all_gather([t[k] for t in per_shard], devices[0])
              for k in range(3)]
    # reduce axis by axis, innermost first: (16, C, W, D_outer, ..., D_inner)
    shape = tuple(totals[0].shape[:3]) + tuple(mesh.shape[ax] for ax in axes)
    totals = tuple(t.reshape(shape) for t in totals)
    for _ in axes:
        totals = msm_sorted._sum_points_lastaxis(totals)
    return _combine_windows(totals, window_bits_for(block))
