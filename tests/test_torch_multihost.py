"""Multi-host mesh rules of the port, in 8 real processes as two hosts.

Counterpart of tests/test_multihost.py: ``parallel.launch`` spawns 8 gloo
ranks with ``LOCAL_WORLD_SIZE=4`` (two "hosts" of 4, as ``torchrun`` would
set on two machines), and each rank checks that

- ``make_mesh_distributed(dp=2, mp=4)`` lays ``mp`` within a host and
  ``dp`` across them;
- ``make_mesh(dp=1, mp=8)`` refuses an ``mp`` axis over both hosts;
- a ``psum`` over ``dp`` crosses the host boundary: 1 + 2 = 3.

The JAX package's mesh on the conftest's 8-device virtual mesh gives the
same shape and the same psum.
"""

import jax
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from mysteryann_tpu.parallel.mesh import make_mesh as jmake_mesh
from mysteryann_tpu_torch.parallel import launch

SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def ranks():
    return launch.run("torch_parallel_ranks:multihost", 8, local_world=4,
                      timeout=SPAWN_TIMEOUT_S)


def test_two_host_mesh(ranks):
    mesh = jmake_mesh(dp=2, mp=4)
    for rank, r in enumerate(ranks):
        assert r["shape"] == dict(mesh.shape) == {"dp": 2, "mp": 4}
        assert r["rows"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        # every rank of one dp row lives on one host (mp inside a host)
        for row in r["rows"]:
            assert len({x // 4 for x in row}) == 1
        assert r["coord"] == (rank // 4, rank % 4)
        assert r["refused"] is not None and "straddle" in r["refused"]
        np.testing.assert_allclose(r["psum_dp"], 3.0)
    # the JAX package's psum over dp on the same layout
    x = np.repeat(np.arange(1, 3, dtype=np.float32), 4)[:, None] * \
        np.ones((8, 4), np.float32)
    f = jax.jit(shard_map(lambda a: jax.lax.psum(a, "dp"), mesh=mesh,
                          in_specs=P("dp", None), out_specs=P(None, None)))
    got = f(jax.device_put(x, NamedSharding(mesh, P("dp", None))))
    np.testing.assert_allclose(np.asarray(got), 3.0)
