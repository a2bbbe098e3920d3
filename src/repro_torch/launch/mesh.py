"""Production meshes: the JAX package's ``launch/mesh.py`` over the
port's ranks.

Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod: 2 pods of
256 = 512 ranks with a leading ``pod`` axis.  The shapes and axis names
are the reference's, so every dry-run cell lines up with one of its
cells.  The port prices ``model`` and ``data`` on the card-to-card link
(``ici``, NVLink 4) and ``pod`` on the network (``dcn``); on H100s a
16-wide ``model`` axis spans two 8-card hosts, a deliberate difference
from the reference's one TPU pod (ROADMAP, "Deliberate differences").

One process walks one rank: :func:`make_production_mesh` builds the
rank's :class:`parallel.mesh.Mesh` over a fake process group of the
whole world (``parallel.mesh.fake_world``), in which collectives move
nothing but are dispatched, so the op walk sees and attributes them.
Defined as functions, so importing this module starts no group.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np

from ..parallel.mesh import Mesh, fake_world, make_host_mesh, mesh_axis_sizes

POD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)


def production_shape(multi_pod: bool = False):
    """(axis names, shape) of a production mesh."""
    if multi_pod:
        return ("pod", "data", "model"), MULTIPOD_SHAPE
    return ("data", "model"), POD_SHAPE


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False, rank: int = 0
                         ) -> Iterator[Mesh]:
    """Rank ``rank``'s view of the production mesh (16 data x 16 model,
    or 2 pod x 16 x 16 with ``multi_pod``), with its axis groups, over a
    fake process group of 256 or 512 ranks that lives as long as the
    context.  Refuses to start inside an initialized process group."""
    names, shape = production_shape(multi_pod)
    with fake_world(int(np.prod(shape)), rank):
        sizes = dict(zip(names, shape))
        yield make_host_mesh(data=sizes["data"], model=sizes["model"],
                             pod=sizes.get("pod", 1))


def mesh_name(mesh) -> str:
    """"multipod" for a mesh (or axis-size dict) with a ``pod`` axis
    wider than 1, else "pod"."""
    return "multipod" if mesh_axis_sizes(mesh).get("pod", 1) > 1 else "pod"


__all__ = ["MULTIPOD_SHAPE", "POD_SHAPE", "make_production_mesh",
           "mesh_name", "production_shape"]
