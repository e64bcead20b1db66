"""The port's late-bounce compaction against the JAX package's: the port's
render_wave with compact_tiers=(2, 4) (plain versions on the CPU) against
the JAX render_wave with use_wide + use_gather_shade and the same tiers,
its TPU kernels in interpret mode, on the same merged tables of the
procedural room at 64x64 (4,096 lanes: the tiers give 2,048 and 1,024), 6
bounces. Both narrow the same bounces (the JAX package through its
lax.cond tiers); the bars are the slice's (tests/test_torch_slice.py): ray
counts within 0.5%, per-pixel |delta| <= 1e-4 on >= 99% of pixels. (The
compile of the JAX program with its two narrow copies of the bounce body
takes most of this file's time.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.config import GPUConfig
from gpu_raytracer_tpu.integrators.pathtracer import render_wave as jax_render_wave
from gpu_raytracer_tpu.ops import pallas_gang as pg
from gpu_raytracer_tpu.ops import pallas_shade_gather as psg
from gpu_raytracer_tpu.ops import pallas_wide as pwd
from gpu_raytracer_tpu.ops.buffers import build_scene_buffers as jax_build
from gpu_raytracer_tpu_torch.integrators.pathtracer import render_wave
from gpu_raytracer_tpu_torch.ops import buffers as tb
from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors
from gpu_raytracer_tpu_torch.scenes import procedural_scene

from tests.test_torch_import import jax_scene_of
from tests.test_torch_import import private_bvh_cache  # noqa: F401

torch.set_num_threads(2)

W = 64
TIERS = (2, 4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (pwd, pg, psg):
        monkeypatch.setattr(mod, "FORCE_INTERPRET", True)


def test_compacted_render_wave_matches_jax():
    scene = jax_scene_of(procedural_scene(W, W, 2))
    jbufs = jax_build(scene)
    ours = tb.from_jax_buffers(scene._host_buffers, jbufs["sampler"], "cpu")
    config = GPUConfig(num_bounces=6)
    jcam = {k: jnp.asarray(v) for k, v in scene.camera.params().items()}
    tcam = camera_tensors(scene.camera.params(), "cpu")
    pix = np.arange(W * W, dtype=np.int32)
    a, ra = jax_render_wave(jbufs, jcam, jnp.asarray(pix), 1, config, W, 0, True, True,
                            use_wide=True, use_gather_shade=True, compact_tiers=TIERS)
    log = []
    b, rb = render_wave(ours, tcam, torch.as_tensor(pix), 1, config, W, 0, True, True,
                        compact_tiers=TIERS, bounce_log=log)
    assert any(w < W * W for _, _, w in log), log
    a, b = np.asarray(a), b.numpy()
    assert abs(float(ra) - int(rb)) <= 0.005 * float(ra), (float(ra), int(rb))
    d = np.abs(a - b).max(axis=1)
    assert np.mean(d <= 1e-4) >= 0.99, np.quantile(d, [0.5, 0.99, 1.0])
    assert a.mean() > 0.01
