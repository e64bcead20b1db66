"""The a-trous pass (K5 `_atrous_kernel`) at the image sizes that run its
kernel's border and remainder code: the plain version (`atrous_plain`, what
the kernel is held to on the card) against one TPU kernel call in interpret
mode (`_run_stencil(partial(_atrous_kernel, step, ...))`), at every step of
the host loop (1 to 32), on

  - 37 x 13: a width that is no multiple of 4 or 32, and steps 16 and 32
    past the image's height (every such tap reads the clamped edge);
  - 9 x 1, 1 x 9 and 1 x 1: one pixel high, one pixel wide, one pixel.

Inputs from numpy with a seed (tests/test_torch_svgf.py `_fake_frame`).
Bar: rtol = atol = 2e-4, the JAX package's own bar between its stencil
kernels and its XLA forms."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.ops import pallas_svgf as psv
from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv

from tests.test_torch_svgf import TOL, _as, _fake_frame, _t

torch.set_num_threads(2)


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("H, W", [(13, 37), (1, 9), (9, 1), (1, 1)])
def test_atrous_plain_matches_pallas_at_the_edges(H, W, step):
    frame, integrated = _fake_frame(H, W, 100 * H + W)
    guide = sv.pack_guide(*(_t(frame[k]) for k in ("normal", "depth", "dz")))
    dyn = sv.pack_dyn(*(_t(integrated[k]) for k in ("direct", "indirect",
                                                     "var_direct", "var_indirect")))
    G, rows_pad, Wc = psv._grid_dims(H, W)
    jf, ji = _as(frame, jnp.asarray), _as(integrated, jnp.asarray)
    g_p = psv.pack_guide(jf["normal"], jf["depth"], jf["dz"], rows_pad)
    d_p = psv.pack_dyn(ji["direct"], ji["indirect"], ji["var_direct"],
                       ji["var_indirect"], rows_pad)
    theirs = psv._run_stencil(partial(psv._atrous_kernel, step, 4.0, 16.0, 10.0),
                              g_p, d_p, G, Wc, True)
    ours = sv.atrous_plain(guide, dyn, step)
    assert ours.shape == (8, H, W)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs)[:, :H, :W], rtol=TOL, atol=TOL)
