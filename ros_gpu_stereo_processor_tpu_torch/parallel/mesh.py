"""The band mesh: an explicit list of devices, one image row band each.

The port of ``ros_gpu_stereo_processor_tpu/parallel/mesh.py``.  The JAX mesh
is single-controller: one process runs ``shard_map`` over n devices.  Its
counterpart here is single-process too: a :class:`BandMesh` holds n devices,
band i of an (H, ...) tensor (rows ``i·H/n`` to ``(i+1)·H/n``) lives on
device i, and the collectives of parallel/frontend.py are tensor copies and
reductions across the band list.  A device may appear more than once, which
gives the same "virtual mesh" the JAX package's CPU tests use:
``make_mesh(4, devices=["cpu"] * 4)`` in tests, ``["cuda:0"] * 4`` on one
card; ``make_mesh(4)`` takes ``cuda:0`` to ``cuda:3``.

:meth:`BandMesh.split` and :meth:`BandMesh.gather` are the counterparts of
placing an array with ``row_sharded`` and reading it back whole;
:meth:`BandMesh.replicate` is ``replicated``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class BandMesh:
    """n devices along the band axis ``axis_names[0]``; every other axis
    name has size 1 (as in the JAX ``make_mesh`` without ``shape``)."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = ("rows",)):
        if not devices:
            raise ValueError("a band mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = {a: 1 for a in self.axis_names}
        self.shape[self.axis_names[0]] = len(self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Row bands of an (H, ...) tensor, band i on device i."""
        H = x.shape[0]
        if H % self.size != 0:
            raise ValueError(f"H={H} not divisible by the mesh's {self.size} bands")
        hb = H // self.size
        return [x[i * hb:(i + 1) * hb].to(d) for i, d in enumerate(self.devices)]

    def gather(self, bands: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor, its bands concatenated on the first device."""
        return torch.cat([b.to(self.devices[0]) for b in bands])

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``x`` on every band's device (one copy per distinct
        device)."""
        copies = {}
        return [copies.setdefault(d, x.to(d)) for d in self.devices]

    def unique_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"BandMesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def make_mesh(
    n_bands: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("rows",),
    devices: Optional[Sequence] = None,
) -> BandMesh:
    """A band mesh of ``n_bands`` bands.  Without ``devices`` it takes the
    first ``n_bands`` CUDA devices and raises if there are fewer; nothing
    falls back to the CPU.  Several bands on one card, or bands on the CPU,
    are asked for by passing ``devices`` (one entry per band)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_bands is None else n_bands
        if n < 1 or n > have:
            raise ValueError(f"requested {n_bands} CUDA devices, have {have}; pass "
                             f"devices= for bands on one card or on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_bands is not None and len(devices) != n_bands:
        raise ValueError(f"{len(devices)} devices given for {n_bands} bands")
    return BandMesh(devices, axis_names)
