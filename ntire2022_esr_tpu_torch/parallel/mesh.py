"""Device meshes for sharded evaluation (counterpart of
``ntire2022_esr_tpu/parallel/mesh.py``).

JAX's multi-device code is one process driving ``jax.devices()``; the port
is the same shape: one Python thread launches every device's work,
asynchronously, over a list of ``torch.device``s. No process group is
involved. A :class:`Mesh` is that list laid out as an array with named
axes, as ``jax.sharding.Mesh`` lays out its devices.

By default a mesh takes ``cuda:0 ... cuda:n-1``. ``devices=`` takes an
explicit list, and it may name one device more than once: a mesh of eight
``torch.device("cpu")`` entries is how the CPU tests stand in for JAX's
eight virtual CPU devices, and ``[cuda:0] * 2`` is how one card runs the
sharded paths. Entries that share a device run one after the other on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index: "cuda" is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An array of ``torch.device`` with one name per axis.

    ``devices`` is the object ndarray of devices, ``axis_names`` the names,
    ``shape`` a name -> size mapping and ``devices.size`` the number of
    entries, as JAX's callers read a ``jax.sharding.Mesh``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D mesh needs {devices.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def distinct(self) -> List[torch.device]:
        """The devices of the mesh, each once, in the order of the entries."""
        return list(dict.fromkeys(self.devices.flat))

    def axis_grid(self, axis: str, batch_axis: Optional[str] = None) -> np.ndarray:
        """The entries as a (groups, ``axis``) array: the groups run along
        ``batch_axis``; without one, the first entry of every other axis."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        if batch_axis is None:
            return arr.reshape(-1, arr.shape[-1])[:1]
        if self.devices.ndim != 2:
            raise ValueError("batch_axis needs a 2-D mesh")
        return arr

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(shape: "Optional[Union[int, Sequence[int]]]" = None,
              axis_names: Optional[Sequence[str]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the first devices: 1-D (``shape`` an int or None = every
    device, axis "data") or N-D (``shape`` a tuple, e.g. ``(4, 2)`` with
    axes ``("data", "space")``). ``devices`` defaults to every CUDA card;
    asking for more entries than it holds raises ``ValueError``."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if shape is None or isinstance(shape, int):
        n = len(devices) if shape is None else int(shape)
        if n > len(devices) or n < 1:
            raise ValueError(f"requested {n} devices, have {len(devices)}")
        arr = np.empty(n, dtype=object)
        arr[:] = devices[:n]
        return Mesh(arr, tuple(axis_names or ("data",)))
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"requested {shape} = {n} devices, have {len(devices)}")
    if axis_names is None:
        axis_names = ("data", "space")[: len(shape)]
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), tuple(axis_names))


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    return make_mesh(n_devices, ("data",))


def data_space_mesh(data: int, space: int, devices: Optional[Sequence] = None) -> Mesh:
    """2-D (data, space) mesh: ``data`` batch-parallel groups x ``space``
    H-slab shards (parallel/spatial.py composes over both axes)."""
    return make_mesh((data, space), ("data", "space"), devices)
