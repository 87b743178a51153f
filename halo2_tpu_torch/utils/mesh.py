"""A mesh of torch devices driven from one process, and its collectives.

The counterpart of `jax.sharding.Mesh` and of the `lax` collectives that
the JAX package's `shard_map` code uses (all_gather, all_to_all,
ppermute).  Both references drive their device pool from one controller
(a `shard_map` program; a GPU pool in one Rust process), and the prover's
host state — its random draws and its transcript — is single, so the
port's mesh is one process holding a list of per-device tensors:

  * `Mesh(devices, axis_names)`: a 1-D or 2-D array of `torch.device`;
    `shape[axis]` is an axis's size, `devices_of(axes)` the devices a
    sharding over those axes uses, in flat (row-major) order.
  * A row-sharded array is a list of D tensors, shard d on the d-th
    device, each holding the d-th contiguous block of the last axis;
    `ShardedArray` wraps such a list for code written against a whole
    array (`.shape`, indexing that keeps the last axis whole).
  * The collectives (and `dist_roll`, a global roll of a row-sharded
    array) are plain functions over lists of shards, built on
    `Tensor.to(device, non_blocking=True)` and `torch.cat`; a transfer
    to the device a tensor is already on makes no copy.  PyTorch orders
    a copy between two cards with both cards' current streams, so no
    side stream is needed.  `lax.axis_index` has no counterpart: code
    loops over the shards, and a shard's index is its place in the list.

Several shards may name the same device: D logical shards on one card run
every sharded code path at shard shapes (each copy is then device-local).
There is no default device list: the caller names the devices.
"""

from __future__ import annotations

import numpy as np
import torch


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Mesh:
    """Devices on named axes: `Mesh([d0, d1, ...], ("x",))` or a nested
    list for a 2-D mesh, `Mesh([[d0, d1], [d2, d3]], ("dcn", "ici"))`.
    A bare "cuda" becomes "cuda:0"."""

    def __init__(self, devices, axis_names=("x",)):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D device array for axes "
                             f"{tuple(axis_names)}")
        flat = [_canonical(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.reshape(-1)[i] = d
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def flat(self) -> list:
        """Every device, in row-major order."""
        return list(self.devices.reshape(-1))

    def axes(self, axis) -> tuple:
        """An axis name or a tuple of them (outermost first) as a tuple,
        checked against the mesh."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for ax in axes:
            if ax not in self.shape:
                raise ValueError(f"mesh has no axis {ax!r}")
        return axes

    def size(self, axis) -> int:
        d = 1
        for ax in self.axes(axis):
            d *= self.shape[ax]
        return d

    def devices_of(self, axis) -> list:
        """The devices a sharding over `axis` (a name or a tuple, outermost
        first) places its shards on, shard by shard: every index of those
        axes in row-major order, the other axes at index 0."""
        axes = self.axes(axis)
        order = [self.axis_names.index(ax) for ax in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        view = np.transpose(self.devices, order + rest)
        for _ in rest:
            view = view[..., 0]
        return list(view.reshape(-1))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.flat]}, "
                f"shape={self.shape})")


# -- collectives over lists of shards -------------------------------------

def to(t: torch.Tensor, device) -> torch.Tensor:
    """t on `device`; the same tensor when it is there already."""
    return t.to(device, non_blocking=True)


def gather(shards, device, dim: int = -1) -> torch.Tensor:
    """The whole array on one device: the shards concatenated along `dim`
    (the blocks of a row-sharded array, in order)."""
    parts = [to(s, device) for s in shards]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def all_gather(shards, device, dim: int = -1) -> torch.Tensor:
    """`lax.all_gather` to one device: the shards stacked on a new axis
    at `dim`."""
    return torch.stack([to(s, device) for s in shards], dim=dim)


def scatter(x: torch.Tensor, devices, dim: int = -1) -> list:
    """A whole array as row shards: its `dim` cut into len(devices) equal
    contiguous blocks, block d on devices[d] (views where the device is
    x's)."""
    D = len(devices)
    size = x.shape[dim]
    if size % D:
        raise ValueError(f"axis of {size} does not split over {D} devices")
    step = size // D
    return [to(x.narrow(dim, d * step, step), dev)
            for d, dev in enumerate(devices)]


def all_to_all(shards, devices, split_axis: int, concat_axis: int) -> list:
    """`lax.all_to_all(tiled=True)`: shard j's `split_axis` is cut into D
    blocks, block d goes to shard d, which concatenates what it receives
    along `concat_axis` in the order of the senders."""
    D = len(devices)
    size = shards[0].shape[split_axis]
    if size % D:
        raise ValueError(f"axis of {size} does not split over {D} devices")
    step = size // D
    return [torch.cat([to(s.narrow(split_axis, d * step, step), dev)
                       for s in shards], dim=concat_axis)
            for d, dev in enumerate(devices)]


def ppermute(shards, devices, pairs) -> list:
    """`lax.ppermute`: for each (source, destination) pair, shard
    `source`'s tensor goes to shard `destination`; a shard that no pair
    names receives None."""
    out = [None] * len(devices)
    for src, dst in pairs:
        out[dst] = to(shards[src], devices[dst])
    return out


def dist_roll(shards, devices, shift: int) -> list:
    """Global left roll by `shift` rows of a row-sharded array (shard d,
    of L rows, on devices[d]), as torch.roll(x, -shift, -1) rolls the
    whole.  With shift = q*L + r, shard d's output is
    src_{d+q}[r:] ++ src_{d+q+1}[:r]: two transfers a shard (one when
    r == 0).  The prover's rotations (rot_scale and
    (blinders+1)*rot_scale rows) have q == 0, so only r boundary rows
    cross between neighbours (the JAX package's _dist_roll)."""
    D = len(shards)
    L = shards[0].shape[-1]
    q, r = divmod(shift % (D * L), L)
    if q == 0 and r == 0:
        return list(shards)
    if r == 0:
        return ppermute(shards, devices, [((d + q) % D, d) for d in range(D)])
    tails = ppermute([x[..., r:] for x in shards], devices,
                     [((d + q) % D, d) for d in range(D)])
    heads = ppermute([x[..., :r] for x in shards], devices,
                     [((d + q + 1) % D, d) for d in range(D)])
    return [torch.cat([t, h], dim=-1) for t, h in zip(tails, heads)]


class ShardedArray:
    """A row-sharded array: D tensors (16, *B, L), shard d holding rows
    [d*L, (d+1)*L) of the last axis.  Indexing applies to every shard and
    must keep the last axis whole."""

    def __init__(self, shards):
        self.shards = list(shards)

    @property
    def shape(self) -> tuple:
        s = tuple(self.shards[0].shape)
        return s[:-1] + (s[-1] * len(self.shards),)

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if Ellipsis in idx or (len(idx) == self.ndim
                               and idx[-1] != slice(None)):
            raise IndexError("a sharded array keeps its last axis whole")
        return ShardedArray([s[idx] for s in self.shards])

    def map(self, fn) -> "ShardedArray":
        return ShardedArray([fn(s) for s in self.shards])

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on `device` (default: the first shard's)."""
        return gather(self.shards,
                      self.shards[0].device if device is None else device)


class Replicated:
    """A small tensor (a scalar's limbs, a table) with one copy on every
    device that asks for it, made at the first ask."""

    def __init__(self, value: torch.Tensor):
        self._copies = {value.device: value}
        self._value = value

    def on(self, device) -> torch.Tensor:
        dev = torch.device(device)
        t = self._copies.get(dev)
        if t is None:
            t = self._copies[dev] = to(self._value, dev)
        return t
