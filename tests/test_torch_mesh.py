"""``parallel.mesh``: ``world`` within a process group and ``make_mesh``
against the JAX package's ``make_mesh`` (the 8-device CPU mesh of
``tests/conftest.py``).  The layout is checked in one process, with the
size of the default group and the creation of the groups stood in for;
the 4-rank gloo world (``test_torch_gloo4.py``) runs real meshes."""

import jax
import numpy as np
import pytest

from graph_odenet_tpu.parallel import make_mesh as jmake_mesh
from graph_odenet_tpu_torch.parallel import Mesh, make_mesh, mesh, world


def test_world_and_mesh_without_a_process_group():
    assert world() == world(None) == (1, 0)
    m = make_mesh()
    assert isinstance(m, Mesh)
    assert (m.shape, m.axis_names, m.coords, m.groups) == ((1, 1), ("data", "edge"), (0, 0),
                                                           (None, None))
    m = make_mesh(axis_names=("edge",))
    assert (m.shape, m.size("edge"), m.coord("edge"), m.group("edge")) == ((1,), 1, 0, None)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2,), ("edge",))
    with pytest.raises(ValueError, match="axes"):
        make_mesh((1, 1), ("edge",))
    with pytest.raises(KeyError, match="feat"):
        m.size("feat")


@pytest.mark.parametrize("shape,names", [
    ((8,), ("edge",)), ((4, 2), ("edge", "feat")), ((2, 4), ("data", "edge")),
    ((2, 2, 2), ("data", "edge", "feat")), (None, ("data", "edge")),
])
def test_make_mesh_lays_ranks_out_as_jax_does(monkeypatch, shape, names):
    jm = jmake_mesh(shape, names, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    n = ids.size
    for rank in range(n):
        made = []

        def subgroups(lines, rank=rank, made=made):
            made.append(lines)
            return next(tuple(line) for line in lines if rank in line), None

        monkeypatch.setattr(mesh, "world", lambda group=None, rank=rank: (n, rank))
        monkeypatch.setattr(mesh.dist, "new_subgroups_by_enumeration", subgroups)
        m = make_mesh(shape, names)
        assert m.shape == ids.shape
        assert m.coords == tuple(int(c) for c in np.argwhere(ids == rank)[0])
        # Each axis's group: the ranks that differ from this one along it alone.
        lines = iter(made)
        for a, size in enumerate(m.shape):
            along = np.moveaxis(ids, a, -1).reshape(-1, size)
            if size == n:
                assert m.groups[a] is None  # the default group
                continue
            assert next(lines) == along.tolist()
            assert m.groups[a] == tuple(int(r) for r in along[(along == rank).any(1)][0])
        assert next(lines, None) is None
