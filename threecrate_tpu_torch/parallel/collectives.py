"""Collectives over the shards of a mesh, driven by one controller.

The port's counterpart of ``jax.shard_map`` and of ``lax.ppermute``,
``psum``, ``pmin``, ``pmax``, ``all_gather``, ``axis_index`` and
``axis_size``. A JAX ``shard_map`` body runs once per device and its
collectives meet across devices; here a body runs once for the whole
mesh and sees every shard: each argument is a list with one tensor a
shard (flat, row-major over ``mesh.devices``), and each collective takes
such a list and returns one. A collective over an axis joins the shards
that differ only in that axis (``Mesh.axis_groups``), so on a 2-D mesh
it acts along the named axis alone.

Each result lands on the device of the shard that owns it: a tensor
goes to another device by a (non-blocking) copy, and stays as it is
where both shards share a device. Results may therefore alias one
another or an input; bodies treat every shard's tensor as immutable.

Reductions add (or take the min / max) in rank order along the axis on
the first shard's device, then copy the result out, so every shard
holds the same bits and a run repeats bit for bit: no atomics.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .mesh import Mesh, PartitionSpec, Sharded, put

Shards = List[torch.Tensor]


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, non_blocking=x.device.type == "cuda" and device.type == "cuda")


def axis_size(mesh: Mesh, axis_name: str) -> int:
    """The number of shards along ``axis_name`` (``lax.axis_size``)."""
    mesh._axis(axis_name)
    return mesh.shape[axis_name]


def axis_index(mesh: Mesh, axis_name: str) -> List[int]:
    """Each flat shard's position along ``axis_name`` (``lax.axis_index``)."""
    mesh._axis(axis_name)
    return [int(mesh.coords(i)[axis_name]) for i in range(mesh.size)]


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str,
             perm: Sequence) -> Shards:
    """``lax.ppermute``: ``perm`` holds (source, destination) positions
    along ``axis_name``; every shard that no pair sends to receives
    zeros of its own operand's shape and dtype."""
    devs = mesh.device_list
    dsts = [dst for _, dst in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a destination appears twice in {perm}")
    out = [None] * len(xs)
    for group in mesh.axis_groups(axis_name):
        for src, dst in perm:
            out[group[dst]] = _to(xs[group[src]], devs[group[dst]])
    return [torch.zeros_like(x) if o is None else o for x, o in zip(xs, out)]


def _reduce(xs, mesh, axis_name, op) -> Shards:
    devs = mesh.device_list
    out = [None] * len(xs)
    for group in mesh.axis_groups(axis_name):
        home = devs[group[0]]
        acc = xs[group[0]]
        for i in group[1:]:
            acc = op(acc, _to(xs[i], home))
        for i in group:
            out[i] = _to(acc, devs[i])
    return out


def psum(xs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str) -> Shards:
    """``lax.psum``: the sum over the axis, added in rank order."""
    return _reduce(xs, mesh, axis_name, torch.add)


def pmin(xs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str) -> Shards:
    return _reduce(xs, mesh, axis_name, torch.minimum)


def pmax(xs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str) -> Shards:
    return _reduce(xs, mesh, axis_name, torch.maximum)


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis_name: str,
               tiled: bool = False) -> Shards:
    """``lax.all_gather``: every shard receives the axis's operands stacked
    on a new leading axis, or with ``tiled`` concatenated along the
    leading axis. One copy is built per device of each group."""
    devs = mesh.device_list
    out = [None] * len(xs)
    for group in mesh.axis_groups(axis_name):
        built = {}
        for i in group:
            if devs[i] not in built:
                parts = [_to(xs[j], devs[i]) for j in group]
                built[devs[i]] = torch.cat(parts) if tiled else torch.stack(parts)
            out[i] = built[devs[i]]
    return out


def shard_map(body: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map`` for one controller. The returned function places
    each argument by its spec (a ``Sharded`` laid out so is used as it is;
    tensors, arrays and numbers are split, or copied to every device
    under ``PartitionSpec()``), calls ``body`` once with one list of
    shards per argument, and wraps what it returns: one list per output
    (or one list where ``out_specs`` is a single spec). An output under a
    spec that names an axis comes back as a ``Sharded``; a replicated one
    (``PartitionSpec()``) as the tensor of the mesh's first shard."""
    single = isinstance(out_specs, PartitionSpec)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} arguments, got {len(args)}")
        lists = [list(put(a, mesh, spec).shards) for a, spec in zip(args, in_specs)]
        outs = body(*lists)
        if single:
            outs = (outs,)
        wrapped = tuple(shards[0] if len(spec) == 0 else Sharded(mesh, spec, shards)
                        for shards, spec in zip(outs, out_specs if not single
                                                else (out_specs,)))
        return wrapped[0] if single else wrapped

    return run


__all__ = ["shard_map", "ppermute", "psum", "pmin", "pmax", "all_gather", "axis_index",
           "axis_size"]
