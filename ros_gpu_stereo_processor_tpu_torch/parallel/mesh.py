"""Device meshes: a grid of devices over named axes, and the collectives
along one axis.

The port of ``ros_gpu_stereo_processor_tpu/parallel/mesh.py``.  The JAX mesh
is single-controller: one process runs ``shard_map`` over a device grid.
Its counterpart here is a :class:`Mesh` in one process: a grid of devices of
``shape`` over ``axis_names`` (axis vocabulary as in JAX: ``rows`` = image
row bands, ``disp`` = disparity slabs, ``kf`` = landmark blocks of the
distributed BA).  A device may appear more than once, which gives the same
"virtual mesh" the JAX package's CPU tests use:
``make_mesh(4, devices=["cpu"] * 4)`` in tests, ``["cuda:0"] * 4`` on one
card; ``make_mesh(4)`` takes ``cuda:0`` to ``cuda:3``.

Everything that runs sharded runs on a 1-D mesh: :meth:`Mesh.along` is the
line of the grid along one axis (through its first entry), and
``mesh.along(axis)`` of a 1-D mesh over ``axis`` is the mesh itself.  On a
line, entry i holds part i (band i of an (H, ...) tensor is rows
``i·H/n`` to ``(i+1)·H/n``), and the collectives of ``shard_map`` are
methods that take the list of this process's parts:

  * :meth:`Mesh.shift_down` / :meth:`Mesh.shift_up`: ``ppermute`` i → i + 1
    and i + 1 → i, zeros at the ends;
  * :meth:`Mesh.psum`, :meth:`Mesh.pmin`: the sum (in entry order) and the
    elementwise minimum, one copy per part, computed on the devices (no
    host read);
  * :meth:`Mesh.all_gather`: the parts stacked, (n, ...).

:meth:`Mesh.split` and :meth:`Mesh.gather` are the counterparts of placing
an array with ``row_sharded`` and reading it back whole;
:meth:`Mesh.replicate` is ``replicated``.  In one process every entry is
this process's (``indices`` = 0 .. n−1); parallel/multihost.py's process
mesh has the same methods over ``torch.distributed``, with each process
holding its own entries, so every function of parallel/frontend.py and
parallel/dist_ba.py runs on either unchanged.  ``spans_processes`` says
which: False here, True for a process mesh whose line reaches another
process (its collectives then exchange through the host).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A grid of devices of ``shape`` over ``axis_names``, in one process.
    Without ``shape`` the first axis takes every device and the others
    have size 1 (JAX's ``make_mesh`` without ``shape``)."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = ("rows",),
                 shape: Optional[Tuple[int, ...]] = None):
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        if shape is None:
            shape = (len(devs),) + (1,) * (len(self.axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.axis_names) or math.prod(shape) != len(devs):
            raise ValueError(f"shape {shape} over axes {self.axis_names} does not hold "
                             f"{len(devs)} devices")
        self.shape = dict(zip(self.axis_names, shape))
        self.grid = np.empty(len(devs), dtype=object)
        self.grid[:] = devs
        self.grid = self.grid.reshape(shape)
        self._lines = {}

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """This process's devices, in grid order (on a line: part i's
        device is ``devices[i]``)."""
        return tuple(self.grid.ravel())

    @property
    def size(self) -> int:
        """Entries of the whole grid (of every process)."""
        return self.grid.size

    @property
    def indices(self) -> List[int]:
        """The line index of each of this process's parts."""
        return list(range(self.size))

    def along(self, axis: str) -> "Mesh":
        """The 1-D mesh along ``axis`` through the grid's first entry."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        if self.axis_names == (axis,):
            return self
        if axis not in self._lines:
            ax = self.axis_names.index(axis)
            line = np.moveaxis(self.grid, ax, 0).reshape(self.shape[axis], -1)[:, 0]
            self._lines[axis] = Mesh(list(line), (axis,))
        return self._lines[axis]

    def unique_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    @property
    def spans_processes(self) -> bool:
        """Whether a collective reaches another process: never, in one
        process."""
        return False

    def on_one_device(self) -> bool:
        """Whether every entry is one device in this process (``["cuda:0"] *
        4``): a step over such a mesh may be captured as one CUDA graph
        (utils/graphs.py); one over several devices or processes runs
        eagerly."""
        return not self.spans_processes and len(self.unique_devices()) == 1

    # -- placement (on a line) ------------------------------------------------

    def split(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """This process's bands of ``x`` along ``dim``, band i on its entry's
        device."""
        n = self.size
        if x.shape[dim] % n != 0:
            raise ValueError(f"H={x.shape[dim]} not divisible by the mesh's {n} bands")
        hb = x.shape[dim] // n
        return [x.narrow(dim, i * hb, hb).to(d) for i, d in zip(self.indices, self.devices)]

    def gather(self, bands: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """The whole tensor, its bands concatenated on the first device."""
        return torch.cat([b.to(self.devices[0]) for b in bands], dim)

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``x`` per part (one copy per distinct device)."""
        copies = {}
        return [copies.setdefault(d, x.to(d)) for d in self.devices]

    # -- collectives (on a line) ----------------------------------------------

    def shift_down(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``ppermute`` i → i + 1: part i receives part i − 1, part 0
        receives zeros."""
        return [torch.zeros_like(parts[0]).to(self.devices[0])] + [
            p.to(d) for p, d in zip(parts[:-1], self.devices[1:])]

    def shift_up(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``ppermute`` i + 1 → i: part i receives part i + 1, the last part
        receives zeros."""
        return [p.to(d) for p, d in zip(parts[1:], self.devices[:-1])] + [
            torch.zeros_like(parts[-1]).to(self.devices[-1])]

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of the parts, added in entry order, one copy per part."""
        return self.replicate(_fold(parts, self.devices[0], torch.add))

    def pmin(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise minimum of the parts, one copy per part."""
        return self.replicate(_fold(parts, self.devices[0], torch.minimum))

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every part stacked, (n, ...), on the first device; what the parts
        compute from it is computed there once and sent back."""
        return torch.stack([p.to(self.devices[0]) for p in parts])

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names}, "
                f"shape={tuple(self.shape.values())})")


def _fold(parts: Sequence[torch.Tensor], device, op) -> torch.Tensor:
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = op(acc, p.to(device))
    return acc


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("rows",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh of ``n_devices`` entries over ``axis_names`` (``shape`` for
    more than one axis of size > 1, e.g. ``make_mesh(8, ("kf", "rows"),
    shape=(2, 4))``).  Without ``devices`` it takes the first ``n_devices``
    CUDA devices and raises if there are fewer; nothing falls back to the
    CPU.  Several entries on one card, or entries on the CPU, are asked for
    by passing ``devices`` (one per entry, in grid order)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise ValueError(f"requested {n_devices} CUDA devices, have {have}; pass "
                             f"devices= for entries on one card or on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None and len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for {n_devices} entries")
    return Mesh(devices, axis_names, shape)
