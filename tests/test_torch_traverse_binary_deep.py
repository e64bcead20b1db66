"""The binary traversal's drop rule at the stack's real depth: the plain
version (`binary_traverse.trace_plain`, 48 entries, unpatched; what K8 is
held to on the card) against the TPU kernel (`pallas_traverse._trace_pallas`
in interpret mode, STACK_DEPTH 48) on hand-made tables whose BLAS is a
chain 80 interior nodes deep under an instance leaf
(`parity.deep_binary_tables`): a +z ray pushes a far leaf at most levels, so
its stack (RESTORE at the bottom) fills and the pushes past 48 entries are
dropped, with their leaves. Bars: hit masks, tri, inst and occlusion equal
on every ray (stricter than tests/test_torch_traverse_binary.py's 99.9%); t
within rtol 1e-4 and u, v within atol 1e-4 (XLA on the CPU contracts
products into FMAs, ROADMAP C6); and the rule bites: with a stack of 200
the plain version finds nearer hits on many rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.ops import pallas_traverse as ptv
from gpu_raytracer_tpu_torch import parity
from gpu_raytracer_tpu_torch.ops import binary_traverse as bt

torch.set_num_threads(2)

DEPTH = 80
N = 1024


@pytest.fixture(scope="module")
def case():
    """The tables, the rays and the TPU kernel's closest and any hits (one
    interpret-mode compile each)."""
    mats = parity.deep_binary_tables(DEPTH, seed=1)
    rays = parity.deep_binary_rays(N, seed=2)
    jm, jr = [jnp.asarray(x) for x in mats], [jnp.asarray(x) for x in rays]
    closest = ptv.trace_closest_pallas(*jm, *jr, interpret=True)
    occluded = ptv.trace_any_pallas(*jm, *jr, interpret=True)
    tables = bt.make_tables(*(torch.as_tensor(x) for x in mats))
    return tables, [torch.as_tensor(x) for x in rays], closest, np.asarray(occluded)


def test_tables_are_deeper_than_the_stack(case):
    tables = case[0]
    assert ptv.STACK_DEPTH == bt.STACK_DEPTH == 48
    count = tables.nodes[:, 13]
    assert int((count == 0).sum()) == DEPTH > bt.STACK_DEPTH
    assert int((count == -1).sum()) == 1


def test_closest_matches_the_kernel_with_drops(case):
    tables, rays, theirs, _ = case
    ours = bt.trace_closest_plain(tables, *rays)
    for name in ("tri", "inst"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    hit = ours.tri >= 0
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(theirs.t), rtol=1e-4)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(ours, name).numpy()[hit.numpy()],
                                   np.asarray(getattr(theirs, name))[hit.numpy()], atol=1e-4)
    assert int(hit.sum()) > N // 2 and bool((ours.inst[hit] == 0).all())


def test_any_matches_the_kernel(case):
    tables, rays, _, occluded = case
    np.testing.assert_array_equal(bt.trace_any_plain(tables, *rays).numpy(), occluded)


def test_the_drop_rule_bites(case, monkeypatch):
    """A stack of 200 keeps every push: on many rays a nearer leaf, pushed
    past the 48th entry, is found; with 48 it is lost, as in the kernel."""
    tables, rays, _, _ = case
    cut = bt.trace_closest_plain(tables, *rays)
    monkeypatch.setattr(bt, "STACK_DEPTH", 200)
    full = bt.trace_closest_plain(tables, *rays)
    lost = (cut.tri >= 0) & (full.t < cut.t)
    assert int(lost.sum()) > N // 8
    assert bool((full.t <= cut.t).all())
