"""The variance pass (K5 `_variance_kernel`) at the image sizes that run its
kernel's halo and border code: the plain version (`variance_plain`, what
the kernel is held to on the card) against one TPU kernel call in interpret
mode (`_run_stencil(partial(_variance_kernel, ...))`) on

  - 37 x 13: a width that is no multiple of the kernel's 32 x 16 tile, and a
    height whose last tile is cut (halo pixels at clamped indices);
  - 9 x 1, 1 x 9 and 1 x 1: one pixel high, one pixel wide, one pixel (every
    halo pixel is a clamped copy);
  - 70 x 19: three tiles across and two down, the last of each cut;

each with `sigma_n` 16 (the kernel's static instance) and 12.5 (its
run-time instance, through exp/log). Inputs from numpy with a seed
(tests/test_torch_svgf.py `_fake_frame`). Bar: rtol = atol = 2e-4, the JAX
package's own bar between its stencil kernels and its XLA forms."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.ops import pallas_svgf as psv
from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv

from tests.test_torch_svgf import TOL, _as, _fake_frame, _t

torch.set_num_threads(2)


@pytest.mark.parametrize("sigma_n", [16.0, 12.5])
@pytest.mark.parametrize("H, W", [(13, 37), (1, 9), (9, 1), (1, 1), (19, 70)])
def test_variance_plain_matches_pallas_at_the_edges(H, W, sigma_n):
    frame, integrated = _fake_frame(H, W, 100 * H + W)
    guide = sv.pack_guide(*(_t(frame[k]) for k in ("normal", "depth", "dz")))
    dyn = sv.pack_dyn(*(_t(integrated[k]) for k in ("direct", "indirect",
                                                     "var_direct", "var_indirect")))
    G, rows_pad, Wc = psv._grid_dims(H, W)
    jf, ji = _as(frame, jnp.asarray), _as(integrated, jnp.asarray)
    g_p = psv.pack_guide(jf["normal"], jf["depth"], jf["dz"], rows_pad)
    d_p = psv.pack_dyn(ji["direct"], ji["indirect"], ji["var_direct"],
                       ji["var_indirect"], rows_pad)
    theirs = psv._run_stencil(partial(psv._variance_kernel, 4.0, sigma_n, 10.0),
                              g_p, d_p, G, Wc, True)
    ours = sv.variance_plain(guide, dyn, 4.0, sigma_n, 10.0)
    assert ours.shape == (8, H, W)
    assert sv.variance_instance(sigma_n) == ("static" if sigma_n == 16.0 else "runtime")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs)[:, :H, :W], rtol=TOL, atol=TOL)
