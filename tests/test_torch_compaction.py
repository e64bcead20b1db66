"""Late-bounce wavefront compaction (render_wave `compact_tiers`): a
compacted render equals the full-width render of the same wave, lane for
lane, on every route that compacts, at 64x64 (4,096 lanes, so the tiers 2
and 4 give narrow waves of 2,048 and 1,024 lanes), 6 bounces, on the
CPU's plain versions:

  - the merged and two-level wide routes, the binary route and the paged
    route (under test_torch_stream_tables.py's patched budgets), tiers
    (2, 4);
  - sparse waves (every 7th lane valid, under the tier 4; every 3rd,
    under 2 and 4, narrowed twice), narrowed at bounce 1; the masked lanes
    stay black;
  - the tiny-wave guard: tiers (64, 4096) give no narrow width at 4,096;
  - media, textures and AOVs under SVGF demodulation together, every AOV;
  - `Pathtracer` passing the tiers of its wave to every wave of a sample,
    the masked tail wave included, to denoised frames, and reporting them;
  - `default_compact_tiers` equal to the JAX package's over a grid.

Bar: rtol 0, atol 1e-6 (the JAX package's compaction test's), bit-equality
expected; equal ray counts. The port with tiers against the JAX
render_wave with the same tiers: test_torch_compaction_jax.py."""

import dataclasses

import pytest
import torch

from gpu_raytracer_tpu.config import GPUConfig as JaxGPUConfig
from gpu_raytracer_tpu.integrators.pathtracer import (
    default_compact_tiers as jax_default_compact_tiers,
)
from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
from gpu_raytracer_tpu_torch.integrators import pathtracer as ptm
from gpu_raytracer_tpu_torch.integrators.pathtracer import (
    Pathtracer,
    compact_caps,
    default_compact_tiers,
    render_wave,
)
from gpu_raytracer_tpu_torch.ops import kulla_conty as kc
from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors
from gpu_raytracer_tpu_torch.scene.types import Medium
from gpu_raytracer_tpu_torch.scenes import instanced_scene, mixed_scene, procedural_scene

from tests.test_torch_import import force_stream, force_two_level
from tests.test_torch_import import private_bvh_cache  # noqa: F401

torch.set_num_threads(2)

W = 64
R = W * W
CONFIG = GPUConfig(num_bounces=6)
PIX = torch.arange(R)


def _pathtracer(scene, config=CONFIG, batch_size=R):
    pt = Pathtracer(scene, CPUConfig(batch_size=batch_size), config, device="cpu")
    pt.init_device()
    return pt


@pytest.fixture(scope="module")
def tables():
    """{layout: (scene, buffers)} for the merged, two-level and paged
    tables of the W x W procedural scenes."""
    out = {}
    scene = procedural_scene(W, W, 2)
    out["merged"] = (scene, _pathtracer(scene).buffers)
    with force_two_level():
        scene = instanced_scene(W, W, grid=3, sphere_subdivisions=1)
        out["two_level"] = (scene, _pathtracer(scene).buffers)
    with force_stream():
        scene = procedural_scene(W, W, 2)
        out["stream"] = (scene, _pathtracer(scene).buffers)
    assert out["two_level"][1]["wide"].two_level
    assert out["stream"][1]["stream"] is not None and out["merged"][1]["binary"] is not None
    return out


def _render(scene, buffers, tiers, route="wide", config=CONFIG, mask=None,
            with_aovs=False):
    """(result, rays, bounce log) of sample 1 of the whole W x W wave."""
    log = []
    out, rays = render_wave(buffers, camera_tensors(scene.camera.params(), "cpu"), PIX, 1,
                            config, W, 0, scene.has_lights, True, valid_mask=mask,
                            with_aovs=with_aovs, route=route, compact_tiers=tiers,
                            bounce_log=log)
    return out, int(rays), log


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _narrowed(log, width=R):
    """Whether some bounce ran narrower than `width`, each on a wave that
    holds its live lanes."""
    assert all(live <= w for _, live, w in log), log
    return any(w < width for _, _, w in log)


@pytest.mark.parametrize("layout, route", [("merged", "wide"), ("two_level", "wide"),
                                           ("merged", "binary"), ("stream", "stream")])
def test_compacted_equals_full_width(tables, layout, route):
    scene, buffers = tables[layout]
    full, rays_full, log_full = _render(scene, buffers, (), route)
    out, rays, log = _render(scene, buffers, (2, 4), route)
    assert not _narrowed(log_full) and _narrowed(log), log
    assert {w for _, _, w in log} <= {R, 2048, 1024}
    # The same lanes were live at every bounce, whatever the wave's width.
    assert [live for _, live, _ in log] == [live for _, live, _ in log_full]
    _same(out, full)
    assert rays == rays_full and float(full.mean()) > 0.01


@pytest.mark.parametrize("step, tiers, widths", [(7, (4,), [1024]),
                                                 (3, (2, 4), [2048, 1024])])
def test_sparse_wave_narrows_at_bounce_1(tables, step, tiers, widths):
    """Every `step`-th lane valid: the wave narrows at bounce 1 and, with
    two tiers, again when the live lanes fit the smaller one."""
    scene, buffers = tables["merged"]
    mask = torch.zeros(R, dtype=torch.bool)
    mask[::step] = True
    full, rays_full, _ = _render(scene, buffers, (), mask=mask)
    out, rays, log = _render(scene, buffers, tiers, mask=mask)
    assert log[0][0] == 1 and sorted({w for _, _, w in log}, reverse=True) == widths, log
    _same(out, full)
    assert rays == rays_full
    assert torch.all(out[~mask] == 0) and float(out[mask].mean()) > 0.01


def test_tiny_wave_guard(tables):
    scene, buffers = tables["merged"]
    config = GPUConfig(num_bounces=3)
    assert compact_caps(R, (64, 4096)) == ()
    full, rays_full, _ = _render(scene, buffers, (), config=config)
    out, rays, log = _render(scene, buffers, (64, 4096), config=config)
    assert [w for _, _, w in log] == [R, R]
    _same(out, full)
    assert rays == rays_full


def test_compact_caps():
    assert compact_caps(R, (2, 4)) == (1024, 2048)
    assert compact_caps(R, (4, 2, 2, 1, 0)) == (1024, 2048)
    assert compact_caps(777_600, (16,)) == (49_152,)  # ceil(48,600 / 1024) * 1024
    assert compact_caps(2047, (2,)) == ()


def test_media_textures_and_aovs(monkeypatch):
    """Media (a medium inside the glass ball), textures and AOVs with SVGF
    demodulation: the whole wave under (2, 4), and every 3rd lane under 2,
    which narrows at bounce 1, where `direct` takes the shade's add. (The
    Kulla-Conty bake takes 512 samples, as the port's bake test's.)"""
    monkeypatch.setattr(kc, "DEFAULT_SAMPLES", 512)
    scene = mixed_scene(W, W, 1, textured=True)
    glass = next(m for m in scene.materials if m.name == "glass")
    glass.medium_id = scene.add_medium(
        Medium.from_sigmas("fog", [0.3, 0.35, 0.5], [2.7, 3.15, 4.5], g=0.6))
    config = GPUConfig(num_bounces=6, enable_svgf=True)
    buffers = _pathtracer(scene, config).buffers
    assert buffers["has_media"] and buffers["has_textures"]
    sparse = torch.zeros(R, dtype=torch.bool)
    sparse[::3] = True
    for mask, tiers in ((None, (2, 4)), (sparse, (2,))):
        full, rays_full, _ = _render(scene, buffers, (), config=config, mask=mask,
                                     with_aovs=True)
        out, rays, log = _render(scene, buffers, tiers, config=config, mask=mask,
                                 with_aovs=True)
        assert _narrowed(log) and (mask is None or log[0][2] == 2048), log
        assert out.keys() == full.keys() and "direct" in out
        for k in out:
            _same(out[k], full[k])
        assert rays == rays_full and float(full["direct"].mean()) > 0.0


def test_pathtracer_passes_and_reports_the_tiers(monkeypatch):
    """Two waves of 3,072 pixels (the tail wave 1,024 pixels and 2,048
    clamped duplicates, dead from the start): with tiers (2,) every wave
    narrows to 2,048 lanes, the tail wave at bounce 1; the image, the ray
    count and a denoised frame equal the full-width ones."""
    scene = procedural_scene(W, W, 2)
    config = dataclasses.replace(CONFIG, enable_svgf=False)
    images = {}
    for tiers in ((), (2,)):
        monkeypatch.setattr(ptm, "default_compact_tiers", lambda n, c, t=tiers: t)
        pt = _pathtracer(scene, config, batch_size=3 * 1024)
        pt.render()
        report = pt.compaction
        assert report["tiers"] == tiers and report["caps"] == compact_caps(3 * 1024, tiers)
        widths = [w for _, _, w in report["bounces"]]
        assert widths == [2048 if tiers and live <= 2048 else 3 * 1024
                          for _, live, _ in report["bounces"]]
        assert (2048 in widths) == bool(tiers)
        assert report["waves_narrowed"] == (2 if tiers else 0)
        assert pt._tiers("binary_shade") == ()
        svgf = Pathtracer(scene, CPUConfig(batch_size=3 * 1024),
                          dataclasses.replace(config, enable_svgf=True), device="cpu")
        svgf.share_tables(pt)
        frame = svgf.render_frame_denoised()
        images[tiers] = (pt.framebuffer(), pt.rays_traced, frame)
    (a, rays_a, fa), (b, rays_b, fb) = images[()], images[(2,)]
    assert rays_a == rays_b and float(a.mean()) > 0.01
    _same(torch.as_tensor(b), torch.as_tensor(a))
    _same(fb, fa)


def test_pathtracer_tail_wave_narrows_at_bounce_1():
    """The tail wave's clamped duplicates never get a slot: its 1,024 valid
    lanes fit the tier 2's 2,048 from bounce 1."""
    scene = procedural_scene(W, W, 2)
    pt = _pathtracer(scene, batch_size=3 * 1024)
    camera = camera_tensors(scene.camera.params(), "cpu")
    waves = list(pt._waves())
    idx, mask, count = waves[-1]
    assert count == 1024 and int(mask.sum()) == 1024
    log = []
    out = render_wave(pt.buffers, camera, idx, 0, CONFIG, W, 0, True, valid_mask=mask,
                      compact_tiers=(2,), bounce_log=log)
    full = render_wave(pt.buffers, camera, idx, 0, CONFIG, W, 0, True, valid_mask=mask)
    assert log[0][0] == 1 and log[0][2] == 2048 and log[0][1] <= 1024, log
    _same(out, full)
    assert torch.all(out[count:] == 0)


@pytest.mark.parametrize("num_bounces", [1, 3, 4, 6, 10, 48])
def test_default_compact_tiers_match_jax(num_bounces):
    for r in (1024, 4096, (1 << 18) - 1, 1 << 18, 777_600, 2_073_600):
        assert default_compact_tiers(r, GPUConfig(num_bounces=num_bounces)) == \
            jax_default_compact_tiers(r, JaxGPUConfig(num_bounces=num_bounces)), r
