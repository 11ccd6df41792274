"""The port's collectives (miotts_tpu_torch.ops.collective) and make_mesh
on 4 gloo ranks on the CPU: psum / all_gather / ppermute, and the ring
collective dots against the JAX package's ring_allreduce_dot /
ring_reduce_scatter_dot (shard_map on meshes of the same shape) at 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from miotts_tpu.ops.collective import ring_allreduce_dot, ring_reduce_scatter_dot
from miotts_tpu.parallel.mesh import make_mesh
from miotts_tpu_torch.parallel.launch import launch
from torch_port_util import few_torch_threads  # noqa: F401

import torch_parallel_workers as W

WORLD = 4
SHAPES = [(1, WORLD), (2, WORLD // 2)]
M, K, N = 4, 256, 64


@pytest.fixture(scope="module")
def xw():
    rng = np.random.default_rng(42)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(xw):
    return launch(W.collective_rank, WORLD, xw, timeout=120)


def test_make_mesh_shapes(ranks):
    for res in ranks:
        assert res["shapes"] == {"[]": (1, 4), "[('data', 2)]": (2, 2),
                                 "[('model', 2)]": (2, 2),
                                 "[('data', 1), ('model', 4)]": (1, 4)}
        assert res["error"] == "mesh 3x1 != 4 devices"


@pytest.mark.parametrize("shape", SHAPES)
def test_psum_all_gather_ppermute(ranks, shape):
    for res in ranks:
        out = res[shape]
        r, n = out["rank"], out["size"]
        vals = [np.array([i + 1.0, 10.0 * (i + 1)]) for i in range(n)]
        np.testing.assert_array_equal(out["psum"], sum(vals))
        np.testing.assert_array_equal(out["gather"], np.concatenate(vals))
        np.testing.assert_array_equal(out["right"], vals[(r - 1) % n])
        np.testing.assert_array_equal(out["left"], vals[(r + 1) % n])


def _jax_ring(fn, shape, x, w, out_spec):
    mesh = make_mesh(data=shape[0], model=shape[1],
                     devices=jax.devices()[:shape[0] * shape[1]])
    f = jax.shard_map(lambda a, b: fn(a, b, "model"), mesh=mesh,
                      in_specs=(P(None, "model"), P("model", None)),
                      out_specs=out_spec, check_vma=False)
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(f)(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_allreduce_dot_matches_jax(ranks, xw, shape):
    want = _jax_ring(ring_allreduce_dot, shape, *xw, P())
    for res in ranks:
        np.testing.assert_allclose(res[shape]["allreduce"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res[shape]["allreduce"], xw[0] @ xw[1],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_reduce_scatter_dot_matches_jax(ranks, xw, shape):
    """Rank d of 'model' holds column chunk d, JAX's device d's."""
    want = _jax_ring(ring_reduce_scatter_dot, shape, *xw, P(None, "model"))
    for res in ranks:
        out = res[shape]
        nc = N // out["size"]
        np.testing.assert_allclose(
            out["scatter"], want[:, out["rank"] * nc:(out["rank"] + 1) * nc],
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_allreduce_matches_psum(ranks, shape):
    """The ring against the bulk psum of the local products."""
    for res in ranks:
        np.testing.assert_allclose(res[shape]["allreduce"],
                                   res[shape]["bulk"], rtol=1e-5, atol=1e-5)
