"""Shared helpers for the tests that hold miotts_tpu_torch against
miotts_tpu: JAX parameter trees -> nested numpy (the input of the port's
convert.py), the output-scale error, and a torch thread cap."""

import numpy as np
import pytest
import torch

from miotts_tpu.ops.qmat import QTensor


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch intra-op threads while a port test module runs (restored
    after): the suite runs six workers on the machine's cores, and torch's
    default of one thread per core in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_tree_to_numpy(tree):
    """JAX params (dicts / lists of arrays and QTensors) -> numpy leaves,
    a QTensor becoming {values, scales, mins, group, n_out, packed}."""
    if isinstance(tree, QTensor):
        return {"values": np.asarray(tree.values),
                "scales": np.asarray(tree.scales),
                "mins": None if tree.mins is None else np.asarray(tree.mins),
                "group": tree.group, "n_out": tree.n_out,
                "packed": tree.packed}
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def rel_err(got, want) -> float:
    """max |got - want| over the output scale max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))
