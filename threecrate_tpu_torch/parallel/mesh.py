"""Device meshes and the placement of tensors on them.

Counterpart of ``threecrate_tpu.parallel.mesh``. The JAX package shards
a point cloud's N axis (its "points" axis) over a 1-D
``jax.sharding.Mesh``; here a :class:`Mesh` holds an array of
``torch.device`` and the names of its axes, and a :class:`Sharded` value
holds one tensor a device. A mesh may name one device several times:
``make_mesh(8, devices=[torch.device("cuda:0")] * 8)`` runs eight shards
on one card, ``devices=[torch.device("cpu")] * 8`` on the CPU (the
tests' counterpart of JAX's eight virtual CPU devices).

One controller drives every shard (see ``parallel.collectives``), as
``jax.shard_map`` does: no process group, so a single card can hold a
whole ring.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

POINTS_AXIS = "points"


class PartitionSpec(tuple):
    """How a value's leading dimensions map onto mesh axes: one axis name
    (or None, unsplit) per dimension, as ``jax.sharding.PartitionSpec``.
    ``PartitionSpec()`` is replicated on every device."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """An n-D array of devices with one name per axis. ``devices`` may be
    any nested sequence (or numpy array) of ``torch.device`` or device
    strings; ``shape`` maps each axis name to its size, as JAX's
    ``Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh of {self.devices.ndim} axes given "
                             f"{len(self.axis_names)} names {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> list:
        """The devices in row-major order: shard i of a value lives on
        ``device_list[i]``."""
        return list(self.devices.flat)

    def coords(self, i: int) -> dict:
        """{axis name: position} of flat shard ``i``."""
        return dict(zip(self.axis_names, np.unravel_index(i, self.devices.shape)))

    def axis_groups(self, axis_name: str) -> list:
        """The flat shard indices that a collective over ``axis_name``
        joins: one list per combination of the other axes' positions,
        each in order along ``axis_name``."""
        ax = self._axis(axis_name)
        idx = np.moveaxis(np.arange(self.size).reshape(self.devices.shape), ax, -1)
        return [list(map(int, g)) for g in idx.reshape(-1, idx.shape[-1])]

    def _axis(self, axis_name: str) -> int:
        if axis_name not in self.axis_names:
            raise ValueError(f"no mesh axis {axis_name!r} in {self.axis_names}")
        return self.axis_names.index(axis_name)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = POINTS_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the points axis. ``devices`` defaults to every CUDA
    device; it may repeat a device. Raises ``ValueError`` when fewer
    devices exist than ``n_devices`` asks for, or none at all: the port
    never falls back to the CPU unasked."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError(
                "make_mesh found no CUDA device; pass devices= (e.g. "
                "[torch.device('cpu')] * 8 for a host-side mesh, or one card "
                "repeated) to build a mesh anyway")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devices)} "
                "device(s) are available; pass devices= naming a device "
                f"several times (e.g. [torch.device('cuda:0')] * {n_devices}) "
                "to run several shards on one device")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    return Mesh(devices, (axis_name,))


def shard_cloud_spec(axis_name: str = POINTS_AXIS) -> PartitionSpec:
    """PartitionSpec sharding the leading (points) axis."""
    return P(axis_name)


def replicated_spec() -> PartitionSpec:
    return P()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.as_tensor(a if a.flags.writeable else a.copy())


def _blocks(mesh: Mesh, spec: PartitionSpec, shape: Tuple[int, ...]):
    """For each flat shard, the slice of every split dimension, after the
    check that each split dimension divides by its axis size (the check
    ``NamedSharding`` makes)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the value's {len(shape)} "
                         "dimensions")
    sizes = mesh.shape
    for d, name in enumerate(spec):
        if name is None:
            continue
        mesh._axis(name)
        if shape[d] % sizes[name]:
            raise ValueError(
                f"the sharding {spec} over mesh axis {name!r} of size {sizes[name]} "
                f"implies that the global size of dimension {d} should be divisible "
                f"by {sizes[name]}, but it is equal to {shape[d]}")
    out = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        sl = []
        for d, name in enumerate(spec):
            if name is None:
                sl.append(slice(None))
            else:
                w = shape[d] // sizes[name]
                sl.append(slice(c[name] * w, (c[name] + 1) * w))
        out.append(tuple(sl))
    return out


class Sharded:
    """A value laid out over a mesh: ``shards[i]`` is the block of flat
    shard ``i`` (row-major over ``mesh.devices``), on ``mesh.device_list[i]``.
    Dimensions named in ``spec`` are split over those axes; every other
    mesh axis holds copies."""

    __slots__ = ("mesh", "spec", "shards")

    def __init__(self, mesh: Mesh, spec: PartitionSpec, shards: Sequence[torch.Tensor]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} devices")
        self.mesh = mesh
        self.spec = P(*spec)
        self.shards = tuple(shards)

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self.shards[0].shape)
        sizes = self.mesh.shape
        for d, name in enumerate(self.spec):
            if name is not None:
                s[d] *= sizes[name]
        return tuple(s)

    @property
    def dtype(self):
        return self.shards[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (default: the mesh's first
        device)."""
        device = torch.device(device) if device is not None else self.mesh.device_list[0]
        split = [(d, name) for d, name in enumerate(self.spec) if name is not None]
        if not split:
            return self.shards[0].to(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        taken = set()
        for i, sl in enumerate(_blocks(self.mesh, self.spec, self.shape)):
            key = tuple((s.start, s.stop) for s in sl)
            if key not in taken:     # one copy of each block
                taken.add(key)
                out[sl] = self.shards[i].to(device)
        return out

    def numpy(self) -> np.ndarray:
        return self.gather(torch.device("cpu")).numpy()

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")


def put(x, mesh: Mesh, spec: PartitionSpec) -> Sharded:
    """Place ``x`` (a tensor, array or ``Sharded``) on ``mesh`` as ``spec``
    says; a ``Sharded`` already laid out so is returned as it is, any
    other is gathered and split again (as JAX reshards)."""
    spec = P(*spec)
    if isinstance(x, Sharded):
        if x.mesh is mesh and x.spec == spec:
            return x
        x = x.gather()
    x = _as_tensor(x)
    devs = mesh.device_list
    return Sharded(mesh, spec, [x[sl].to(devs[i])
                                for i, sl in enumerate(_blocks(mesh, spec, tuple(x.shape)))])


def put_sharded(x, mesh: Mesh, axis_name: str = POINTS_AXIS) -> Sharded:
    """Place an array with its leading axis sharded over the mesh."""
    return put(x, mesh, P(axis_name))


def put_replicated(x, mesh: Mesh) -> Sharded:
    return put(x, mesh, P())


__all__ = ["POINTS_AXIS", "PartitionSpec", "P", "Mesh", "Sharded", "make_mesh",
           "shard_cloud_spec", "replicated_spec", "put", "put_sharded",
           "put_replicated"]
