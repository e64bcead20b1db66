"""The benchmark's own arithmetic: window over count, percentiles, the
busy union, the kernel names, the roofline counts."""


import numpy as np
import pytest
import torch

from benchmark.harness import profile, yardstick
from benchmark.reference import bvh


def test_window_over_count():
    assert yardstick.per_unit_ms(30.0, 400) == pytest.approx(75.0)
    with pytest.raises(ValueError):
        yardstick.per_unit_ms(1.0, 0)


@pytest.mark.parametrize("q", [50.0, 95.0, 99.0])
def test_percentile_of_all_values(q):
    values = list(np.random.default_rng(3).exponential(100.0, 257))
    assert yardstick.percentile(values, q) == pytest.approx(float(np.percentile(values, q)))


def test_busy_union():
    assert yardstick.busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert yardstick.busy_union([]) == 0.0


@pytest.mark.parametrize("name,ident,args", [
    ("void wt_walk_kernel<0, 0, false>(WtArgs)", "wt_walk_kernel", ["0", "0", "false"]),
    ("_Z14wt_walk_kernelILi1ELi1ELb0EJEEv6WtArgs", "wt_walk_kernel", ["1", "1"]),
    ("void sv_variance_kernel<16>(float const*)", "sv_variance_kernel", ["16"]),
    ("void at::native::vectorized_elementwise_kernel<4, Foo>(int)",
     "vectorized_elementwise_kernel", ["4", "Foo"]),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy", []),
])
def test_kernel_names(name, ident, args):
    assert profile.kernel_id(name) == ident
    assert profile.template_args(name)[:len(args)] == args


def test_roofline_counts_on_a_tiny_scene():
    """The walk's tests: every triangle test is counted, the hits are the
    brute-force closest hits, and the operations follow the counts."""
    g = torch.Generator().manual_seed(1)
    v0 = torch.rand((300, 3), generator=g) * 4 - 2
    v1 = v0 + 0.3 * torch.rand((300, 3), generator=g)
    v2 = v0 + 0.3 * torch.rand((300, 3), generator=g)
    tree = bvh.build(v0, v1, v2)
    o = torch.zeros((500, 3)) + torch.tensor([0.0, 0.0, 5.0])
    d = torch.nn.functional.normalize(torch.rand((500, 3), generator=g)
                                      - torch.tensor([0.5, 0.5, 1.5]))
    stats = {}
    t, prim, _, _ = bvh.trace(tree, o, d, torch.full((500,), float("inf")), stats=stats)
    T = v0.shape[0]
    tb, _, _, hit = bvh.intersect(o.repeat_interleave(T, 0), d.repeat_interleave(T, 0),
                                  v0.repeat(500, 1), (v1 - v0).repeat(500, 1),
                                  (v2 - v0).repeat(500, 1), torch.full((500 * T,), float("inf")))
    brute = torch.where(hit, tb, float("inf")).view(500, T).min(1).values
    assert torch.equal(t, brute)
    assert 0 < stats["triangle"] < 500 * T and stats["node"] > 0
    assert yardstick.walk_ops(stats["node"], stats["triangle"]) == (
        48 * stats["node"] + 52 * stats["triangle"])


def test_bound_and_svgf_bound():
    assert yardstick.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert yardstick.bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
    px = 1920 * 1080
    moved = 4 * 21 * px
    expect = (max(moved / 3.35e9, yardstick.VARIANCE_OPS_PER_PIXEL * px / 67e9)
              + 6 * max(moved / 3.35e9, yardstick.ATROUS_OPS_PER_PIXEL * px / 67e9))
    assert yardstick.svgf_bound_ms(1080, 1920, 6) == pytest.approx(expect)
