"""Device meshes — the port's counterpart of ``repro.launch.mesh``.

A ``Mesh`` names the axes of a grid of ranks, one device a rank: its
``axis_names``, ``shape`` (name → size, in axis order) and, when live,
the ``torch.distributed`` ``DeviceMesh`` over the process group with a
process group for every set of its axes (``group``).  ``Mesh.abstract`` is the counterpart
of JAX's ``AbstractMesh``: names and sizes only, what sharding plans
resolve against.  ``with mesh:`` makes a mesh the ambient one of the
calling thread, which ``distributed.compression.compressed_psum`` reads to
bind its axis name.

``make_debug_mesh`` and ``make_production_mesh`` need the process group
up first (``launch.cluster.initialize_from_env``) and one rank per device
of the mesh: a mesh on the card runs over NCCL, a mesh on the CPU (asked
for by ``device="cpu"``) over gloo, and neither stands in for the
other; a mesh on ``"meta"`` (the dry run's shapes-only tensors) runs
over a ``fake`` group.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..core.registry import resolve_device

_AMBIENT = threading.local()
# a mesh on "meta" is the dry run's: shapes only, over its fake group
# (``launch/cost_analysis.fake_world``)
BACKENDS = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}


def current_mesh() -> Optional["Mesh"]:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


class Mesh:
    def __init__(self, shape: dict, device_mesh=None, device=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        self.device = device
        self._groups = {}
        if device_mesh is not None:
            self._make_groups()

    def _make_groups(self) -> None:
        """A process group for every set of two or more axes that spans
        less than the world: the ranks that share the other axes'
        coordinates, in this set's row-major order.  Every rank creates
        every group (``dist.new_group`` is collective), in one order."""
        ranks = self.device_mesh.mesh
        n = len(self.axis_names)
        for k in range(2, n):
            for axes in itertools.combinations(range(n), k):
                rest = [d for d in range(n) if d not in axes]
                rows = ranks.permute(*rest, *axes).reshape(
                    -1, math.prod(ranks.shape[d] for d in axes))
                names = tuple(self.axis_names[d] for d in axes)
                for row in rows.tolist():
                    g = dist.new_group(ranks=row)
                    if dist.get_rank() in row:
                        self._groups[names] = g

    @classmethod
    def abstract(cls, shape: Sequence[int], names: Sequence[str]) -> "Mesh":
        """Names and sizes, no ranks."""
        if len(shape) != len(names):
            raise ValueError(f"shape {tuple(shape)} and axis names "
                             f"{tuple(names)} differ in length")
        return cls(dict(zip(names, (int(n) for n in shape))))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def live(self) -> bool:
        return self.device_mesh is not None

    def _axes(self, axes) -> tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} not in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def _need_live(self, what: str) -> None:
        if not self.live:
            raise ValueError(f"an abstract mesh {self.shape} has no {what}")

    def coordinate(self, axes) -> int:
        """This rank's index along ``axes`` (several: row-major, the first
        axis major)."""
        self._need_live("ranks")
        axes = self._axes(axes)
        coord = dict(zip(self.axis_names, self.device_mesh.get_coordinate()))
        index = 0
        for a in axes:
            index = index * self.shape[a] + coord[a]
        return index

    def group(self, axes):
        """The process group over ``axes`` (a name or a tuple of names)
        that holds this rank: the ranks that share its coordinates on the
        other axes, in the order of ``coordinate(axes)``."""
        self._need_live("process groups")
        axes = self._axes(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        return self._groups[axes]

    def __enter__(self) -> "Mesh":
        if not hasattr(_AMBIENT, "stack"):
            _AMBIENT.stack = []
        _AMBIENT.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()

    def __repr__(self) -> str:
        kind = f"live on {self.device}" if self.live else "abstract"
        return f"Mesh({self.shape}, {kind})"


def _live_mesh(shape: tuple, names: tuple, device) -> Mesh:
    dev = resolve_device(device)
    need = math.prod(shape)
    up = dist.is_available() and dist.is_initialized()
    have = dist.get_world_size() if up else 1
    if have != need:
        raise ValueError(
            f"a {' x '.join(map(str, shape))} mesh {names} needs {need} "
            f"processes, one per device; the process group has {have}")
    if not up:
        raise RuntimeError("no process group: start one first "
                           "(launch.cluster.initialize_from_env)")
    want = BACKENDS.get(dev.type)
    if want is None or want not in dist.get_backend():
        raise ValueError(f"a mesh on {dev.type} runs over {want}; the "
                         f"process group runs {dist.get_backend()}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cpu" if dev.type == "meta" else dev.type, shape,
                          mesh_dim_names=names)
    return Mesh(dict(zip(names, shape)), dm, dev)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16 × 16 = 256 ranks, one per card; ``multi_pod`` adds a leading
    2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _live_mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over every rank of the process group, whose
    world size must be ``n_data * n_model``."""
    return _live_mesh((n_data, n_model), ("data", "model"), device)
