"""A fake process group for the tests of the port's sharding and dry run.

`mesh2x2` builds a ``("data", "model")`` mesh over the port's fake group
of 512 ranks (`repro_torch.launch.mesh`), started in this process by the
first test that asks for it and kept for the process's life: DTensor
caches layouts by mesh, and a group destroyed and started again under the
same meshes meets those stale entries.  No other test of the CPU suite
starts a default group in its own process (the gloo tests spawn theirs),
so the fake group is in nobody's way.  Import the fixture into a test
module.
"""
import pytest


@pytest.fixture(scope="module")
def mesh2x2():
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((2, 2), ("data", "model"))


class ShapeMesh:
    """A shape-only mesh (the pattern of tests/test_sharding.py's
    FakeMesh): the rules read only axis names and sizes."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)

    @property
    def size(self):
        v = 1
        for s in self.shape.values():
            v *= s
        return v
