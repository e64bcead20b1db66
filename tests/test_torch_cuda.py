"""Hand-written CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: without an NVIDIA GPU every test skips. On a machine
with one (`--noconftest`: tests/conftest.py imports JAX, not needed here):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The bars are gpu_raytracer_tpu_torch/parity.py's, as in chip_smoke.py.
Imports no JAX."""

import pytest
import torch

from gpu_raytracer_tpu_torch import parity as cs

pytestmark = pytest.mark.cuda

W = 64


@pytest.fixture(scope="module")
def pt():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    # Subdivision 4: past the small-scene gates, so the wide route runs.
    p = Pathtracer(procedural_scene(W, W, 4), CPUConfig(batch_size=W * W),
                   GPUConfig(num_bounces=3), device="cuda")
    p.init_device()
    assert p.route() == "wide"
    return p


@pytest.fixture(scope="module")
def captured(pt):
    return cs.capture_wave(pt, W * W)


@pytest.fixture(scope="module")
def pt_tl():
    """The instanced scene (443 instances of one sphere): two-level tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import instanced_scene

    p = Pathtracer(instanced_scene(W, W), CPUConfig(batch_size=W * W),
                   GPUConfig(num_bounces=4), device="cuda")
    p.init_device()
    assert p.buffers["wide"].two_level
    return p


@pytest.mark.parametrize("role", ["primary", "closest", "any"])
def test_two_level_kernel_matches_plain(pt_tl, role):
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    (tables, o, d, tm), _ = cs.capture_wave(pt_tl, W * W)[role]
    assert tables.two_level
    before = wt.launches[role + "_tl"]
    a = getattr(DISPATCH, role)(tables, o, d, tm)
    b = getattr(PLAIN, role)(tables, o, d, tm)
    assert wt.launches[role + "_tl"] == before + 1
    if role == "any":
        cs.compare_any(a, b)
    else:
        cs.compare_closest(a, b, cs.TRI_MATCH_COHERENT if role == "primary"
                           else cs.TRI_MATCH_INCOHERENT, role == "primary", (tables, o, d))
    if role == "primary":  # the closest role may resolve an exact tie to another instance
        assert torch.equal(a.inst, b.inst)


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("role", ["primary", "closest", "any"])
def test_walk_kernel_counters(pt, pt_tl, captured, two_level, role):
    """The persistent-warp kernel's instrumented launch: the same hits by the
    bar (the primary wave's u, v too), its counters (visits within 10% of
    the plain version's: only the order of a ray's visits changes), a
    utilisation in (0, 1]; and the kernel the occupancy API reports for it
    keeps 32 warps an SM."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    got = cs.capture_wave(pt_tl, W * W) if two_level else captured
    (tables, o, d, tm), _ = got[role]
    mode = wt.ROLES.index(role)
    a, stats = wt.trace_stats(mode, tables, o, d, tm)
    b = getattr(PLAIN, role)(tables, o, d, tm)
    if role == "any":
        cs.compare_any(a, b)
    else:
        cs.compare_closest(a, b, cs.TRI_MATCH_COHERENT if role == "primary"
                           else cs.TRI_MATCH_INCOHERENT, role == "primary", (tables, o, d))
    for k in ("nodes", "leaves", "instances"):
        assert abs(stats[k] - wt.last_work[k]) <= 0.1 * wt.last_work[k]
    assert 0.0 < wt.kernel_utilisation(stats) <= 1.0
    assert stats["fetches"] >= (int(tm.shape[0]) + 31) // 32
    info = wt.kernel_info(mode, two_level)
    assert info["blocks_per_sm"] * info["threads"] >= 32 * 32


@pytest.mark.parametrize("role", ["primary", "closest", "any"])
def test_traversal_kernel_matches_plain(pt, captured, role):
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN

    (tables, o, d, tm), _ = captured[role]
    a = getattr(DISPATCH, role)(tables, o, d, tm)
    b = getattr(PLAIN, role)(tables, o, d, tm)
    if role == "any":
        cs.compare_any(a, b)
    else:
        cs.compare_closest(a, b, cs.TRI_MATCH_COHERENT if role == "primary"
                           else cs.TRI_MATCH_INCOHERENT, role == "primary", (tables, o, d))


def test_shade_kernel_matches_plain(pt, captured):
    """K3 from the hits on the bounce-1 wave, and on the same wave with
    every BSDF (the instances given synthetic materials in turn) and ~10%
    of the lanes dead."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg

    (tables, params, lanes), kw = captured["shade"]
    assert not kw["last"] and "u" not in lanes
    before = sg.launches["shade"]
    cs.compare_shade(DISPATCH.shade(tables, params, lanes, **kw),
                     PLAIN.shade(tables, params, lanes, **kw))
    assert sg.launches["shade"] == before + 1
    mixed, params, lanes = cs.mixed_shade_args((tables, params, lanes))
    gen = torch.Generator(device=pt.device).manual_seed(3)
    lanes = dict(lanes, alive=torch.rand(lanes["t"].shape[0], generator=gen,
                                         device=pt.device) < 0.9)
    cs.compare_shade(DISPATCH.shade(mixed, params, lanes, **kw),
                     PLAIN.shade(mixed, params, lanes, **kw))


def test_last_bounce_shade_kernel_matches_plain(pt):
    """K3's last-bounce instance against its plain form on the last bounce's
    wave, and its radiance_add bit-equal to the full instance's on the
    bounce-1 wave."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg

    calls = cs.capture_wave(pt, W * W, every=True)["shade"]
    assert [kw["last"] for _, kw in calls] == [False] * (len(calls) - 1) + [True]
    args, kw = calls[-1]
    before = sg.launches["shade_last"]
    cs.compare_shade_last(DISPATCH.shade(*args, **kw), PLAIN.shade(*args, **kw))
    assert sg.launches["shade_last"] == before + 1
    args, kw = calls[0]
    full = DISPATCH.shade(*args, **kw)["radiance_add"]
    last = DISPATCH.shade(*args, **dict(kw, last=True))["radiance_add"]
    assert torch.equal(full.view(torch.int32), last.view(torch.int32))


@pytest.fixture(scope="module")
def pt_mixed():
    """The mixed, textured scene (every BSDF, three textures): K3's textured
    instances on the wide route and on route (b)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import mixed_scene

    p = Pathtracer(mixed_scene(W, W, 2, True), CPUConfig(batch_size=W * W),
                   GPUConfig(num_bounces=4), device="cuda")
    p.init_device()
    assert p.buffers["wide"] is not None and p.buffers["has_textures"]
    return p


@pytest.mark.parametrize("route", ["wide", "binary"])
def test_textured_shade_kernel_matches_plain(pt_mixed, route):
    """Every K3 call of a sample of the mixed, textured scene (bounce 1 to
    the last; on the binary route the walk's u, v), kernel vs plain."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN

    if route == "binary" and pt_mixed.buffers["binary"] is None:
        pytest.skip("the scene has no binary tables")
    calls = cs.capture_wave(pt_mixed, W * W, route=route, every=True)["shade"]
    assert len(calls) >= 2 and all(kw["textured"] for _, kw in calls)
    for args, kw in calls:
        assert ("u" in args[2]) == (route == "binary")
        got, want = DISPATCH.shade(*args, **kw), PLAIN.shade(*args, **kw)
        if kw["last"]:
            cs.compare_shade_last(got, want)
        else:
            cs.compare_shade(got, want)
            torch.testing.assert_close(got["cone_width"], want["cone_width"],
                                       rtol=cs.SHADE_RTOL, atol=cs.SHADE_ATOL)


@pytest.fixture(scope="module")
def pt_media():
    """The media scene (three dielectric spheres holding an ink, a
    forward-scattering and a thick isotropic medium), 6 bounces: K3's
    SG_MEDIA instances on the wide route and on route (b)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import media_scene

    p = Pathtracer(media_scene(W, W, 2), CPUConfig(batch_size=W * W),
                   GPUConfig(num_bounces=6), device="cuda")
    p.init_device()
    assert p.has_media and p.buffers["fused_shade"] is None
    return p


@pytest.mark.parametrize("route", ["wide", "binary"])
def test_media_shade_kernel_matches_plain(pt_media, route):
    """Every K3 call of a sample of the media scene: the shade bar, and the
    handed-over medium_id equal to the plain version's on every lane."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg

    if route == "binary" and pt_media.buffers["binary"] is None:
        pytest.skip("the scene has no binary tables")
    calls = cs.capture_wave(pt_media, W * W, route=route, every=True)["shade"]
    handed = 0
    for args, kw in calls:
        got, want = DISPATCH.shade(*args, **kw), PLAIN.shade(*args, **kw)
        if kw["last"]:
            assert "medium_id" not in args[2]
            cs.compare_shade_last(got, want)
            continue
        assert sg.mode_of(args[2], kw["textured"], False) & sg.SG_MEDIA
        cs.compare_shade(got, want)
        handed += cs.compare_medium(got, want, args[2]["medium_id"])
    assert handed > 0


@pytest.mark.parametrize("route", ["wide", "binary"])
def test_textured_media_shade_instances_match_plain(pt_mixed, route):
    """SG_TEX | SG_MEDIA (and with SG_UV) on the mixed, textured scene's
    bounce-1 wave, each lane given a seeded medium id (the scene's instance
    rows hold none, so every transmission leaves to -1)."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg

    if route == "binary" and pt_mixed.buffers["binary"] is None:
        pytest.skip("the scene has no binary tables")
    (tables, params, lanes), kw = cs.capture_wave(pt_mixed, W * W, route=route)["shade"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    medium = torch.randint(-1, 3, lanes["t"].shape, device="cuda", generator=gen,
                           dtype=torch.int32)
    lanes = dict(lanes, medium_id=medium)
    assert sg.mode_of(lanes, True, False) == (
        sg.SG_TEX | sg.SG_MEDIA | (sg.SG_UV if route == "binary" else 0))
    got, want = DISPATCH.shade(tables, params, lanes, **kw), PLAIN.shade(tables, params, lanes, **kw)
    cs.compare_shade(got, want)
    assert cs.compare_medium(got, want, medium) > 0


def test_render_media_kernels_match_plain(pt_media):
    _render_pair(pt_media)


def test_ao_kernels_match_plain(pt_media):
    """AO on the wide route (K1 primary, the wide any walk) and route (b)
    (K8), kernels vs plain versions: visibility equal on >= 99.9% of the
    pixels."""
    from gpu_raytracer_tpu_torch.integrators.ao import AO
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN

    for binary in (False, True):
        imgs = []
        for kernels in (None, PLAIN):
            ao = AO(pt_media.scene, pt_media.cpu_config, pt_media.gpu_config, device="cuda",
                    **({} if kernels is None else {"kernels": kernels}))
            ao.buffers = dict(pt_media.buffers)
            if not binary:
                ao.buffers["binary"] = None
            ao.reset_accumulation()
            assert ao.route() == ("binary" if binary else "wide")
            imgs.append(ao.render_samples(2))
        agree = float((imgs[0] == imgs[1]).all(axis=-1).mean())
        assert agree >= 0.999, (binary, agree)


@pytest.mark.parametrize("num_bounces", [2, 3, 4])
def test_bounce_loop_glue_on_the_card(pt, num_bounces):
    """On CUDA tensors the bounce loop calls none of the pre-stage helpers
    (rederive_uv, interpolate_hit, iso_texture_tap, row gathers) after
    bounce 0, draws nothing on the last bounce and traces no shadow wave
    there."""
    base = cs.loop_glue_calls(pt, 1)
    got = cs.loop_glue_calls(pt, num_bounces)
    for k in ("rederive_uv", "interpolate_hit", "iso_texture_tap", "fetch_rows"):
        assert got[k] == base[k], (k, got, base)
    assert got["last_bounce_draws"] == 0
    assert got["roles"]["any"] == num_bounces - 1
    assert got["roles"]["shade"] == num_bounces - 1


def test_shade_kernel_info():
    """The compiler's report of every K3 instance: the lane stays in
    registers, so the stack frame holds only sample_disk's sinf / cosf
    argument-reduction slow path (32 bytes; the lane-form kernel's was 240)
    and the last-bounce instance has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg

    for mode in sg.MODES:
        info = sg.kernel_info(mode)
        assert info["blocks_per_sm"] >= 1 and info["sms"] > 0
        assert info["local_bytes"] <= (0 if mode == sg.SG_LAST else 32), (mode, info)


@pytest.fixture(scope="module")
def pt_svgf(pt):
    """The procedural room under SVGF + TAA (the merged tables of `pt`)."""
    from gpu_raytracer_tpu_torch import GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer

    p = Pathtracer(pt.scene, pt.cpu_config, GPUConfig(num_bounces=3, enable_svgf=True),
                   device="cuda")
    p.buffers = pt.buffers
    p.reset_accumulation()
    return p


def test_svgf_kernels_match_plain(pt_svgf):
    """Both K5 kernels against their plain versions on the inputs of a
    captured denoised frame (history of 4 frames: both sides of the
    length < 4 select)."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv

    got = cs.capture_svgf(pt_svgf, 5)
    length = got["length"]
    assert bool((length < 4).any()) and bool((length >= 4).any())
    assert len(got["svgf_variance"]) == 1 and len(got["svgf_atrous"]) == 6
    for role in ("svgf_variance", "svgf_atrous"):
        for args, kw in got[role]:
            before = sv.launches[role]
            a = getattr(DISPATCH, role)(*args, **kw)
            b = getattr(PLAIN, role)(*args, **kw)
            assert sv.launches[role] == before + 1
            cs.compare_stencil(a, b)


def _stencil_images(H, W, seed):
    """Seeded guide (5, H, W) and dyn (8, H, W) images on the card: unit
    normals, depths with a sky band (1e30), dz, colours and variances."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = rng.normal(size=(3, H, W))
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    depth = rng.uniform(1.0, 10.0, (1, H, W))
    depth[:, : H // 4] = 1e30
    guide = np.concatenate([n, depth, rng.uniform(1e-3, 0.5, (1, H, W))])
    dyn = np.concatenate([rng.uniform(0, 2, (3, H, W)), rng.uniform(0, 1, (3, H, W)),
                          rng.uniform(0, 0.5, (2, H, W))])
    return (torch.as_tensor(guide.astype(np.float32), device="cuda"),
            torch.as_tensor(dyn.astype(np.float32), device="cuda"))


@pytest.mark.parametrize("step", [1, 2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("H, W", [(13, 37), (1, 9), (9, 1), (1, 1), (40, 64), (70, 1920)])
def test_atrous_kernel_edges_match_plain(H, W, step):
    """The a-trous kernel's border path (clamped taps) and interior path:
    widths that are not a multiple of 4 or 32, steps past the image, 1-pixel
    rows and columns, and images with an interior at every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv

    guide, dyn = _stencil_images(H, W, 100 * H + W)
    cs.compare_stencil(sv.svgf_atrous(guide, dyn, step), sv.atrous_plain(guide, dyn, step))


def test_atrous_kernel_matches_plain_at_1080p():
    """Every a-trous step of a captured 1920x1080 denoised frame (the fifth;
    a scene past the small-scene gates) against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN, Pathtracer
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    p = Pathtracer(procedural_scene(1920, 1080, 4), CPUConfig(),
                   GPUConfig(num_bounces=2, enable_svgf=True), device="cuda")
    p.init_device()
    got = cs.capture_svgf(p, 5)
    steps = [args[2] for args, _ in got["svgf_atrous"]]
    assert steps == [1, 2, 4, 8, 16, 32]
    for args, kw in got["svgf_atrous"]:
        cs.compare_stencil(DISPATCH.svgf_atrous(*args, **kw), PLAIN.svgf_atrous(*args, **kw))


def test_demod_shade_kernel_matches_plain(pt_svgf):
    """K3 as the denoised path launches it: demod=True with rr_albedo."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN

    (tables, params, lanes), kw = cs.capture_wave(pt_svgf, W * W, with_aovs=True)["shade"]
    assert kw["demod"] and "rr_albedo" in lanes
    cs.compare_shade(DISPATCH.shade(tables, params, lanes, **kw),
                     PLAIN.shade(tables, params, lanes, **kw))


def test_denoised_kernels_match_plain(pt_svgf):
    """Four denoised frames, kernels vs plain versions, by the image bar."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN, Pathtracer

    runs = []
    for kernels in (None, PLAIN):
        p = Pathtracer(pt_svgf.scene, pt_svgf.cpu_config, pt_svgf.gpu_config,
                       device="cuda", **({} if kernels is None else {"kernels": kernels}))
        p.buffers = pt_svgf.buffers
        p.reset_accumulation()
        frames = [p.render_frame_denoised().cpu().numpy() for _ in range(4)]
        runs.append((frames, p.rays_traced))
    (fa, ra), (fb, rb) = runs
    for a, b in zip(fa, fb):
        cs.compare_images(a, b, ra, rb)


def _render_pair(pt):
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN, Pathtracer

    imgs, rays = [], []
    for kernels in (None, PLAIN):
        p = Pathtracer(pt.scene, pt.cpu_config, pt.gpu_config, device="cuda",
                       **({} if kernels is None else {"kernels": kernels}))
        p.buffers = pt.buffers
        p.reset_accumulation()
        imgs.append(p.render_samples(4))
        rays.append(p.rays_traced)
    cs.compare_images(*imgs, *rays)


def test_render_kernels_match_plain(pt):
    _render_pair(pt)


def test_render_two_level_kernels_match_plain(pt_tl):
    _render_pair(pt_tl)


@pytest.mark.parametrize("sigma_n", [16.0, 8.0, 12.5])
@pytest.mark.parametrize("H, W", [(13, 37), (1, 9), (9, 1), (1, 1), (40, 64), (70, 1920)])
def test_variance_kernel_edges_match_plain(H, W, sigma_n):
    """The variance kernel's shared-memory window at the image's border
    (halo pixels at clamped indices), widths that are not a multiple of its
    32 x 16 tile, 1-pixel rows and columns; each instance: the static one
    (sigma_n 16) and the run-time one (an integer and a non-integer
    exponent)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv

    guide, dyn = _stencil_images(H, W, 100 * H + W)
    instance = "static" if sigma_n == 16.0 else "runtime"
    before = sv.variance_instances[instance]
    got = sv.svgf_variance(guide, dyn, 4.0, sigma_n, 10.0)
    assert sv.variance_instances[instance] == before + 1
    cs.compare_stencil(got, sv.variance_plain(guide, dyn, 4.0, sigma_n, 10.0))


@pytest.mark.parametrize("any_hit", [False, True])
def test_binary_kernel_drops_pushes_as_plain(any_hit):
    """K8 on tables whose chain is deeper than the 48-entry stack: the
    pushes past it are dropped as trace_plain drops them (the next item held
    in a register counts as a stack slot)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt

    tables = bt.make_tables(*(torch.as_tensor(x, device="cuda")
                              for x in cs.deep_binary_tables()))
    o, d, tm = (torch.as_tensor(x, device="cuda") for x in cs.deep_binary_rays(4096))
    kernel = bt.trace_any if any_hit else bt.trace_closest
    got, want = kernel(tables, o, d, tm), bt.trace_plain(any_hit, tables, o, d, tm)
    if any_hit:
        cs.compare_any(got, want)
    else:
        cs.compare_binary(got, want)


@pytest.mark.parametrize("any_hit", [False, True])
def test_binary_kernel_info(any_hit):
    """The compiler and the occupancy API's report: 32 warps an SM (the
    persistent any-hit grid's size), the 48-int stack in the frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt

    info = bt.kernel_info(any_hit)
    assert info["threads"] == 128 and info["blocks_per_sm"] >= 8
    assert info["local_bytes"] >= 4 * bt.STACK_DEPTH and info["sms"] > 0


@pytest.fixture(scope="module")
def pt_small():
    """The Cornell stand-in: binary tables under both small-scene gates."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import cornell_scene

    p = Pathtracer(cornell_scene(W, W), CPUConfig(batch_size=W * W),
                   GPUConfig(num_bounces=6), device="cuda")
    p.init_device()
    assert p.route() == "binary_shade"
    return p


@pytest.mark.parametrize("sample", [0, 4100])
def test_small_scene_kernels_match_plain(pt_small, sample):
    """K8 (closest and any) and K7 against their plain versions on every
    call of a captured wave, in and past the 4096-sample table."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    got = cs.capture_wave(pt_small, W * W, route="binary_shade", sample=sample,
                          every=True)
    before = dict(bt.launches), fs.launches["fused_shade"]
    for args, _ in got["binary_closest"]:
        cs.compare_binary(DISPATCH.binary_closest(*args), PLAIN.binary_closest(*args))
    for args, _ in got["binary_any"]:
        cs.compare_any(DISPATCH.binary_any(*args), PLAIN.binary_any(*args))
    for args, kw in got["fused_shade"]:
        cs.compare_shade(DISPATCH.fused_shade(*args, **kw), PLAIN.fused_shade(*args, **kw))
    assert bt.launches["binary_closest"] == before[0]["binary_closest"] + len(got["binary_closest"])
    assert fs.launches["fused_shade"] == before[1] + len(got["fused_shade"])


@pytest.fixture(scope="module")
def fused_calls(pt_small):
    """Every fused shade call of sample 0 on the Cornell stand-in (bounce
    0 to the last, most lanes dead by bounce 4)."""
    got = cs.capture_wave(pt_small, W * W, route="binary_shade", every=True)["fused_shade"]
    assert len(got) >= 5
    return got


def _dead(args):
    dead = list(args)
    dead[7] = torch.zeros_like(dead[7])
    return tuple(dead)


@pytest.mark.parametrize("wave", ["mixed_b1", "mixed_b4", "late_b4", "dead_b1"])
def test_fused_shade_kernel_waves(fused_calls, wave):
    """K7 against its plain version on every BSDF (the synthetic mixed
    tables) at bounce 1 and on a late bounce, on the late bounce itself,
    and on a wave whose lanes are all dead (only what is read of a dead
    lane: its throughput's RR scale, its NEE flag, its ray)."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    kind, bounce = wave.split("_b")
    args, kw = fused_calls[int(bounce)]
    if kind == "mixed":
        args = cs.mixed_fused_args(args)
    elif kind == "dead":
        args = _dead(args)
    live = int(args[7].sum())
    assert (live == 0) == (kind == "dead")
    if kind != "dead":  # most lanes dead on the late bounce, some on bounce 1
        assert (live < args[7].numel() // 4) == (bounce == "4")
    before = fs.launches["fused_shade"]
    got, want = DISPATCH.fused_shade(*args, **kw), PLAIN.fused_shade(*args, **kw)
    cs.compare_shade(got, want)
    assert fs.launches["fused_shade"] == before + 1
    if kind == "dead":
        assert not got["alive"].any() and (got["shadow_tmax"] == 0).all()
        assert torch.equal(got["ray_o"], args[4]) and torch.equal(got["ray_d"], args[5])
        assert (got["radiance_add"] == 0).all()


def _padded_tables(tables, T, I, L):
    """`tables` (JAX layout) with its triangles, instances and lights moved
    to the end of tables T, I and L columns long (the padding copies the
    first of each, the padded lights' CDF entries are 0 so that the pick
    lands on the same light), and the shifts of the ids."""
    tri_geo, tri_nrm, inst_a, inst_b, mat_tbl, kc_tbl, lgt_tbl = (x.clone() for x in tables)
    dt, di, dl = T - tri_geo.shape[1], I - inst_a.shape[1], L - lgt_tbl.shape[1]

    def pad(x, k):
        return torch.cat([x[:, :1].expand(-1, k), x], dim=1)

    lgt_tbl[1] += dt
    lgt_tbl[2] += di
    lgt = pad(lgt_tbl, dl)
    lgt[0, :dl] = 0.0
    return (pad(tri_geo, dt), pad(tri_nrm, dt), pad(inst_a, di), pad(inst_b, di),
            mat_tbl, kc_tbl, lgt), dt, di


def test_fused_shade_kernel_at_the_gate(pt_small, fused_calls):
    """K7 on tables at the route's gate (64 (2T + 2I + L + 16) <= 600,000
    bytes) that hold the Cornell scene's rows at their end: bit-equal to
    K7 on the scene's own tables where the bar reads, and to the plain
    version by the bar."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    args, kw = fused_calls[1]
    T, I, L = 3679, 500, 1000
    assert 64 * (2 * T + 2 * I + L + 16) <= fs.MAX_SHADE_TABLE_BYTES
    cols, dt, di = _padded_tables(fs.plain_tables(args[0]), T, I, L)
    hit = args[3]
    hit = bt.Hit(hit.t, torch.where(hit.tri >= 0, hit.tri + dt, hit.tri),
                 torch.where(hit.inst >= 0, hit.inst + di, hit.inst), hit.u, hit.v)
    big = (fs.make_tables(cols), args[1], args[2], hit) + tuple(args[4:])
    got = DISPATCH.fused_shade(*big, **kw)
    cs.compare_shade(got, PLAIN.fused_shade(*big, **kw))
    assert cs.shade_lanes_differ(got, DISPATCH.fused_shade(*args, **kw)) == 0


def test_fused_shade_kernel_info():
    """The compiler's report: the lane's material and curves stay in
    registers, so the stack frame holds only the argument-reduction slow
    path of sample_disk's sinf / cosf (32 bytes; the parent kernel's 240
    held the whole lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    info = fs.kernel_info()
    assert info["blocks_per_sm"] >= 1 and info["sms"] > 0
    assert info["local_bytes"] <= 32


@pytest.mark.parametrize("size", [(W, W), (48, 40)])
def test_small_scene_routes_match_plain(pt_small, size):
    """Route (a) (film sides multiples of 32) and route (b) (not), kernels
    vs plain versions by the image bar."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN, Pathtracer
    from gpu_raytracer_tpu_torch.scenes import cornell_scene

    scene = cornell_scene(*size)
    imgs, rays = [], []
    for kernels in (None, PLAIN):
        p = Pathtracer(scene, pt_small.cpu_config, pt_small.gpu_config, device="cuda",
                       **({} if kernels is None else {"kernels": kernels}))
        p.buffers = pt_small.buffers
        p.reset_accumulation()
        assert p.route() == ("binary_shade" if size == (W, W) else "binary")
        imgs.append(p.render_samples(4))
        rays.append(p.rays_traced)
    cs.compare_images(*imgs, *rays)


def test_sah_tables_past_the_gate_match_plain():
    """`--bvh sah` past the small-scene gate: every wave on the binary kernel
    (route (b)), kernels vs plain versions by the image bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.config import BVHType
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    scene = procedural_scene(W, W, 4)
    scene.config = CPUConfig(bvh_type=BVHType.BVH2, batch_size=W * W)
    p = Pathtracer(scene, scene.config, GPUConfig(num_bounces=3), device="cuda")
    p.init_device()
    assert p.buffers["wide"] is None and p.buffers["fused_shade"] is None
    assert p.route() == "binary"
    _render_pair(p)


@pytest.fixture(scope="module")
def pt_stream():
    """The procedural room on paged tables: the port's routing budget cut to
    8 MiB and 48-row pages (tests/test_torch_import.force_stream patches the
    same constants, in both packages)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.bvh import stream as stream_mod
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import buffers as tb
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    p = Pathtracer(procedural_scene(W, W, 4), CPUConfig(batch_size=W * W),
                   GPUConfig(num_bounces=3), device="cuda")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb, "VMEM_LIMIT", 8 * 1024 * 1024)
        mp.setattr(stream_mod, "PAGE_ROWS", 48)
        p.init_device()
    assert p.route() == "stream"
    return p


def test_stream_kernels_match_plain(pt_stream):
    """K6: both passes, closest and any, against their plain versions on
    every wave of a captured sample (window 0 and, on the closest waves, the
    next window), and the whole paged trace against the plain trace: the
    resident pass bit-equal, the page pass and the trace's closest hit by
    the tie-aware bar, any hit exact."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st

    got = cs.capture_wave(pt_stream, W * W, route="stream", every=True)
    before = dict(st.launches)
    for role, any_hit in (("stream_closest", False), ("stream_any", True)):
        for (tables, o, d, tm), _ in got[role]:
            for skip in (0, st.K_PORTALS):
                res = st.resident_kernel(any_hit, tables, o, d, tm, skip)
                cs.compare_stream_pass(res, st.resident_plain(any_hit, tables, o, d, tm, skip),
                                       ("t", "tri", "pid", "pt", "ovf"))
            t1, tri1, pid, pt, _ = st.resident_kernel(any_hit, tables, o, d, tm)
            assert pid.t().is_contiguous() and pt.t().is_contiguous()  # slot-major
            args = (o, d, tm, pid, pt, torch.where(tri1 >= 0, t1, tm), tri1)
            a, b = st.page_kernel(any_hit, tables, *args), st.page_plain(any_hit, tables, *args)
            if any_hit:
                cs.compare_stream_pass(a, b, ("t", "tri"))
                cs.compare_any(DISPATCH.stream_any(tables, o, d, tm),
                               PLAIN.stream_any(tables, o, d, tm))
            else:
                cs.compare_stream_closest(a, b, (tables, o, d))
                (a, ra), (b, rb) = (DISPATCH.stream_closest(tables, o, d, tm),
                                    PLAIN.stream_closest(tables, o, d, tm))
                assert torch.equal(ra, rb)
                cs.compare_stream_closest(a, b, (tables, o, d))
    assert all(st.launches[n] > before[n] for n in st.NAMES)


@pytest.mark.parametrize("kind", ["resident", "page"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_pass_counters(pt_stream, kind, any_hit):
    """K6's instrumented launches: the same results by the pass's bar, the
    resident pass's visits equal to the plain version's (its order), the
    page pass's within 10% (postponed leaves), a utilisation in (0, 1]; and
    the kernel the occupancy API reports keeps 32 warps an SM."""
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    got = cs.capture_wave(pt_stream, W * W, route="stream", every=True)
    (tables, o, d, tm), _ = got["stream_any" if any_hit else "stream_closest"][1]
    t1, tri1, pid, pt, _ = st.resident_plain(any_hit, tables, o, d, tm)
    args = (o, d, tm) if kind == "resident" else \
        (o, d, tm, pid, pt, torch.where(tri1 >= 0, t1, tm), tri1)
    a, stats = st.pass_stats(kind, any_hit, tables, *args)
    b = (st.resident_plain if kind == "resident" else st.page_plain)(any_hit, tables, *args)
    work = st.last_work[st._name(kind, any_hit)]
    if kind == "resident":
        cs.compare_stream_pass(a, b, ("t", "tri", "pid", "pt", "ovf"))
        assert (stats["nodes"], stats["triangles"]) == (work["nodes"], work["triangles"])
        assert stats["leaf_phases"] == 0
    else:
        if any_hit:
            cs.compare_stream_pass(a, b, ("t", "tri"))
        else:
            cs.compare_stream_closest(a, b, (tables, o, d))
        assert abs(stats["nodes"] - work["nodes"]) <= 0.1 * work["nodes"]
        assert stats["leaf_rounds"] == 0
    assert 0.0 < wt.kernel_utilisation(stats) <= 1.0
    info = st.kernel_info(kind, any_hit)
    assert info["blocks_per_sm"] * info["threads"] >= 32 * 32


def test_render_stream_kernels_match_plain(pt_stream):
    _render_pair(pt_stream)


@pytest.fixture(scope="module")
def probe_wave(pt):
    """The room's bounce-1 wave (4 tiles) and tables for the probes."""
    from gpu_raytracer_tpu_torch import probes

    return probes.bounce1(pt)


@pytest.mark.parametrize("variant", ["full", "node-only", "tri-only", "nosort", "nopush",
                                     "nopushst", "noload", "nored", "pushbase", "sorthalf"])
def test_probe_gang_ablate_kernel_matches_plain(probe_wave, variant):
    """pg_ablate against its plain version at 64 fixed iterations: tri equal,
    t bit-equal. nopush and nopushst are held here only: they pop slots
    nobody pushed (zeroed on both sides; uninitialised scratch in the TPU
    probe), so no JAX reference exists for them."""
    from gpu_raytracer_tpu_torch.probes import gang

    before = gang.launches["pg_ablate"]
    a = gang.ablate(probe_wave["gt"], probe_wave["wave"], variant, 64)
    b = gang.ablate_plain(probe_wave["gt"], probe_wave["wave"], variant, 64)
    assert gang.launches["pg_ablate"] == before + 1
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)


@pytest.mark.parametrize("case", ["ragged", "dead", "k1", "converge"])
def test_probe_gang_ablate_edge_cases(probe_wave, case):
    """pg_ablate against its plain version (tri, iters equal, t bit-equal),
    every variant: on 2,972 rays (3 tiles, the last padded with dead
    lanes), on 2 tiles with every 7th t_max 0 and every 11th negative, at 1
    iteration; and `full` run to its end (converge), each tile's iterations
    equal."""
    from gpu_raytracer_tpu_torch.probes import gang

    o, d, tm = probe_wave["wave"]
    k, variants, converge = 64, gang.ABLATE_VARIANTS, False
    if case == "ragged":
        o, d, tm = o[:2972], d[:2972], tm[:2972]
    elif case == "dead":
        o, d, tm = o[:2048], d[:2048], tm[:2048].clone()
        tm[::7] = 0.0
        tm[3::11] = -1.0
    elif case == "k1":
        k = 1
    else:
        k, variants, converge = 1 << 16, ("full",), True
    for v in variants:
        a = gang.ablate(probe_wave["gt"], (o, d, tm), v, k, converge)
        b = gang.ablate_plain(probe_wave["gt"], (o, d, tm), v, k, converge)
        assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t), v
        assert torch.equal(a.iters, b.iters), v
    if converge:
        assert 0 < int(a.iters.max()) < k


def test_probe_gang_ablate_keeps_several_tiles_an_sm():
    """pg_ablate's report: one 256-thread block a tile (a warp a gang), at
    least two tiles resident on an SM, no stack frame."""
    _needs_card()
    from gpu_raytracer_tpu_torch.probes import gang

    for v in gang.ABLATE_VARIANTS:
        info = gang.kernel_info(v)
        assert info["threads"] == gang.TILE_THREADS and info["blocks_per_sm"] >= 2, (v, info)
        assert info["local_bytes"] == 0, (v, info)


def test_probe_gang_converged_matches_closest_kernel(probe_wave):
    """The gang traversal run to its end finds K2's hits (ties aside)."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH
    from gpu_raytracer_tpu_torch.probes import gang

    row = gang.converged_vs_closest(probe_wave["gt"], probe_wave["tables"],
                                    probe_wave["wave"], DISPATCH.closest)
    assert row["hits"] > 0 and row["tri_match"] >= 0.999


@pytest.mark.parametrize("stage", ["loop", "pop", "load", "slab", "sort", "push"])
def test_probe_gang_micro_kernel_matches_plain(probe_wave, stage):
    """pg_micro (a 32-thread block a gang) against its plain version at
    1, 4 and 64 tiles (the room's 4 bounce-1 tiles, then seeded origins) and
    0, 1, 64 and 512 iterations: acc bit-equal, one launch a call."""
    import numpy as np

    from gpu_raytracer_tpu_torch.probes import gang

    table, rays = gang.micro_inputs(probe_wave["gt"], probe_wave["wave"], 4)
    more = np.random.default_rng(6).uniform(-0.4, 1.8, (60, 8, 128)).astype(np.float32)
    rays = torch.cat([rays, torch.as_tensor(more, device="cuda")])
    for tiles in (1, 4, 64):
        for n_iters in (0, 1, 64, 512):
            before = gang.launches["pg_micro"]
            got = gang.micro(table, rays[:tiles], stage, n_iters)
            assert gang.launches["pg_micro"] == before + 1
            assert torch.equal(got, gang.micro_plain(table, rays[:tiles], stage, n_iters)), \
                (tiles, n_iters)


def test_probe_gang_micro_report():
    """pg_micro's report: a 32-thread block (a gang), no stack frame, no
    cluster."""
    _needs_card()
    from gpu_raytracer_tpu_torch.probes import gang

    for s in gang.MICRO_STAGES:
        info = gang.micro_kernel_info(s)
        assert info["threads"] == 32 and info["local_bytes"] == 0, (s, info)
        assert info["cluster"] == 1 and info["blocks_per_sm"] >= 1, (s, info)


def test_probe_fetch_kernels_match_plain(probe_wave):
    """Every fetch case at the probes' sizes on 2 tiles, 8 iterations, every
    edge case (fetch.EDGE_CASES), and the glue's row gather (pf_lane rows)
    against index_select: kernel against plain with torch.equal
    (fetch_case), each on its kernel, with the path its launcher reported:
    pf_lane stages only what fits and reads quads only for row sums of
    tables over 1 MiB, pf_window stages column 0 for the column modes and
    rows otherwise, in a ring that fits the card."""
    from gpu_raytracer_tpu_torch.probes import fetch

    before = dict(fetch.launches)
    rows = fetch.probe_fetches("cuda", 8, 2)
    assert len(rows) == len(fetch.CASES)
    edges = fetch.edge_fetches("cuda")
    assert len(edges) == len(fetch.EDGE_CASES)
    lane_paths = set()
    for r in rows + edges:
        M, C = r["table"]
        if r["kernel"] == "pf_lane":
            lane_paths.add(r["path"])
            assert r["path"] in fetch.LANE_PATHS
            if r["mode"] == "lane":
                assert r["path"] == "in_place"
            if r["path"] == "quad":
                assert r["mode"] == "rowsum" and 4 * M * C > 1 << 20
            if r["path"] == "staged":
                assert r["launch"]["smem"] >= 4 * M * (C + 1 if r["mode"] == "rowsum" else
                                                       1 if r["mode"] == "col0" else C)
        else:
            assert r["path"] == ("column" if r["mode"] in fetch.COLUMN_MODES else "rows")
            assert r["launch"]["ahead"] >= 0 and r["launch"]["depth"] >= 1
    assert lane_paths == set(fetch.LANE_PATHS)
    by_name = {r["probe"]: r for r in edges}
    assert by_name["edge: one-window ring"]["launch"]["ahead"] == 0
    deep = by_name["edge: window past the deepest ring"]["launch"]
    assert deep["ahead"] >= 1 and (deep["ahead"], deep["depth"]) != (2, 3)
    assert by_name["edge: staged sublane"]["path"] == "staged"
    assert by_name["edge: quad row sums"]["path"] == "quad"
    fetch.glue_fetch(probe_wave["shade_rows"], probe_wave["hit_tri"])
    assert fetch.last_path["pf_lane"]["path"] == "in_place"
    assert fetch.launches["pf_window"] - before["pf_window"] == sum(
        r["kernel"] == "pf_window" for r in rows + edges)
    assert fetch.launches["pf_lane"] - before["pf_lane"] == 1 + sum(
        r["kernel"] == "pf_lane" for r in rows + edges)


@pytest.mark.parametrize("mode, cols", [("col0", 4), ("rowsum", 16)])
def test_probe_fetch_lane_each_side_of_the_staging_limit(mode, cols):
    """pf_lane on enough lanes to fill every SM at 4 lanes a thread, on the
    largest table it stages and on one 4 rows larger, which it reads in
    place: each equals the plain version (torch.equal), and the path each
    reported is the one the card's opt-in shared memory gives (less 128
    bytes; col0 stages 4 bytes a row, rowsum the row and its sum)."""
    _needs_card()
    import numpy as np

    from gpu_raytracer_tpu_torch.ops import _native
    from gpu_raytracer_tpu_torch.probes import fetch

    optin = _native.load().pr_smem_optin()
    per_row = 4 if mode == "col0" else 4 * (cols + 1)
    rows_in = (optin - 128) // per_row // 4 * 4
    lanes = 4 * 512 * torch.cuda.get_device_properties(0).multi_processor_count + 5
    rng = np.random.default_rng(11)
    for M, path in ((rows_in, "staged"), (rows_in + 4, "in_place")):
        table = torch.as_tensor(rng.random((M, cols), dtype=np.float32), device="cuda")
        idx = torch.as_tensor(rng.integers(0, M, (3, lanes), dtype=np.int32), device="cuda")
        before = fetch.launches["pf_lane"]
        row, _ = fetch.fetch_case(table, idx, "lane", mode, 0)
        assert fetch.launches["pf_lane"] == before + 1
        assert row["path"] == path


def test_probe_fetch_unaligned_idx_and_oversized_window():
    """An index view 4 bytes past a 16-byte boundary (pf_window bulk-copies
    index rows, which need 16-byte sources) runs and equals the plain
    version; a window whose smallest ring does not fit the card's shared
    memory raises ValueError before any launch."""
    _needs_card()
    import numpy as np

    from gpu_raytracer_tpu_torch.probes import fetch

    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.random((600, 16), dtype=np.float32), device="cuda")
    iters, R = 3, 2048
    flat = torch.as_tensor(rng.integers(0, 600, iters * R + 1, dtype=np.int32), device="cuda")
    idx = flat[1:].view(iters, R)
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4
    for kind, mode, chunk in (("window", "col0", 64), ("window", "rowsum", 64),
                              ("window", "copy", 64), ("lane", "col0", 0),
                              ("lane", "rowsum", 0)):
        before = fetch.launches["pf_" + kind]
        fetch.fetch_case(table, idx, kind, mode, chunk)  # torch.equal to the plain version
        assert fetch.launches["pf_" + kind] == before + 1
    big = torch.zeros((5000, 16), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fetch.window_fetch(big, torch.zeros((1, 1024), dtype=torch.int32, device="cuda"),
                           "rowsum", 4000)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.mark.parametrize("n, scale", [(20_000, 1.0), (20_000, 1e29), (2048, 1e29), (37, 1.0),
                                      (37, 1e29)])
def test_probe_block_pop_kernel_matches_plain(n, scale):
    """pb_pop (a cluster of blocks) against its plain version at 0, 1, 24,
    256 and 1,000 pops on the probe's table (20,000 rows), a smaller one and
    37 rows (the children wrap, sp reaches the cap), at both scales:
    bit-equal, one launch a call."""
    _needs_card()
    import numpy as np

    from gpu_raytracer_tpu_torch.probes import block

    tab, o, d = (torch.as_tensor(x, device="cuda")
                 for x in block.pop_inputs(np.random.default_rng(2), n, scale))
    for pops in (0, 1, 24, 256, 1000):
        before = block.launches["pb_pop"]
        a = block.pop(tab, o, d, pops)
        assert block.launches["pb_pop"] == before + 1
        assert torch.equal(a, block.pop_plain(tab, o, d, pops)), pops


def test_probe_block_pop_report():
    """pb_pop's report: CLUSTER blocks of LANES / CLUSTER threads, no stack
    frame."""
    _needs_card()
    from gpu_raytracer_tpu_torch.probes import block

    info = block.kernel_info()
    assert info["cluster"] == block.CLUSTER and info["threads"] * block.CLUSTER == block.LANES
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("body", ["A", "B", "C", "D", "E", "roll"])
def test_probe_read_kernel_matches_plain(body):
    """pr_read at 0, 1, 255 and 1,500 pops (a ragged round, more pops than
    the block has threads, none): read in place at 4,096 nodes and staged in
    shared memory at 1,024 (where the table fits: not E's fixed 640 KB),
    bit-equal; its report names one 1024-thread block."""
    _needs_card()
    import numpy as np

    from gpu_raytracer_tpu_torch.probes import read

    rng = np.random.default_rng(4)
    for n, space in ((4096, "ldg"), (1024, "shared")):
        table = torch.as_tensor(read.probe_table(rng, body, n), device="cuda")
        if space == "shared" and table.numel() * 4 > 200_000:
            continue
        for pops in (0, 1, 255, 1500):
            before = read.launches["pr_read"]
            got = read.read(body, table, pops, space)
            assert read.launches["pr_read"] == before + 1
            assert torch.equal(got, read.read_plain(body, table, pops)), (n, space, pops)
        assert read.kernel_info(body, space)["threads"] == 1024


def test_probe_read_ceiling_is_the_device_attribute():
    """The largest dynamic shared memory a launch gets is the opt-in limit;
    16 bytes more is refused."""
    _needs_card()
    from gpu_raytracer_tpu_torch.probes import read

    got = read.smem_ceiling(torch.rand(8, 128, device="cuda"))
    assert got["ceiling_bytes"] == got["attribute_bytes"] > 48 * 1024
    assert got["above_error"] == read.REFUSED


@pytest.mark.parametrize("body", ["single", "stack", "scratch", "full", "smem", "cond",
                                  "maskupd", "v1", "v2", "v3", "v4"])
def test_probe_prims_kernel_matches_plain(body):
    """pp_gang at 512 rows, 40 iterations, on the own and chase tables (and
    `full` on the table times prims.SCALED): bit-equal."""
    _needs_card()
    import numpy as np

    from gpu_raytracer_tpu_torch.probes import prims

    inp = {k: torch.as_tensor(v, device="cuda")
           for k, v in prims.probe_inputs(np.random.default_rng(6), 512).items()}
    for t, t2 in ((inp["table"], inp["table2"]), (inp["chase"], inp["chase2"]),
                  (inp["scaled"], inp["table2"])):
        assert torch.equal(prims.prims(body, t, t2, inp["seed"], 40),
                           prims.prims_plain(body, t, t2, inp["seed"], 40))


@pytest.mark.parametrize("body", ["full", "smem", "v1", "v2"])
def test_probe_prims_redesigned_bodies_at_edges(body):
    """The four bodies with kernels of their own (a warp a gang, the stack
    tops in registers, the chunked gather and ordered sum) at 0, 1, 62, 63
    (smem's stacks fill at 62), a chunk +- 1 and two chunks + 3 iterations,
    on the own, chase and scaled tables at 4096 rows: bit-equal, each call a
    launch of the body's own kernel."""
    _needs_card()
    import numpy as np

    from gpu_raytracer_tpu_torch.probes import prims

    inp = {k: torch.as_tensor(v, device="cuda")
           for k, v in prims.probe_inputs(np.random.default_rng(7)).items()}
    info = prims.kernel_info(body)
    assert info["threads"] == {"full": 32, "smem": 128}.get(body, 1024)
    for t, t2 in ((inp["table"], inp["table2"]), (inp["chase"], inp["chase2"]),
                  (inp["scaled"], inp["table2"])):
        for it in (0, 1, 62, 63, prims.CHUNK - 1, prims.CHUNK + 1, 2 * prims.CHUNK + 3):
            before = prims.launches["pp_gang"]
            got = prims.prims(body, t, t2, inp["seed"], it)
            assert prims.launches["pp_gang"] == before + 1
            assert torch.equal(got, prims.prims_plain(body, t, t2, inp["seed"], it)), it


@pytest.mark.parametrize("mech", ["cp_async", "bulk"])
@pytest.mark.parametrize("count", ["1", "K", "K+1", "64"])
def test_probe_dma_ring_matches_plain(mech, count):
    """The 16 KB-window bodies at 1, K, K + 1 and 64 copies (K the ring's
    slots at the probes' 64 copies), on 1 and 132 windows at once (each its
    own offsets): exact, each body a launch, through a ring of min(K,
    copies) slots."""
    _needs_card()
    from gpu_raytracer_tpu_torch.probes import dma

    K = dma.kernel_info(mech)["ring"]
    assert K > 1
    iters = {"1": 1, "K": K, "K+1": K + 1, "64": 64}[count]
    for blocks in (1, 132):
        before = dma.launches["pd_copy"]
        rows = dma.probe_copies("cuda", iters, blocks, timer=lambda fn: [0.0], mechs=(mech,),
                                bodies=dma.WINDOW_BODIES)
        assert len(rows) == len(dma.WINDOW_BODIES)
        assert dma.launches["pd_copy"] >= before + len(dma.WINDOW_BODIES)
    for offset in dma.OFFSETS:
        assert dma.kernel_info(mech, offset, iters=iters)["ring"] == min(K, iters)


@pytest.mark.parametrize("mech", ["cp_async", "bulk"])
def test_probe_dma_kernel_matches_plain(mech):
    """pd_copy, every body at the probes' sizes with 6 copies where they
    loop (the whole-table bodies on a 2-block cluster), and the window
    bodies on 3 windows at once: exact."""
    _needs_card()
    from gpu_raytracer_tpu_torch.probes import dma

    before = dma.launches["pd_copy"]
    rows = dma.probe_copies("cuda", 6, timer=lambda fn: [0.0], mechs=(mech,))
    rows += dma.probe_copies("cuda", 6, 3, timer=lambda fn: [0.0], mechs=(mech,),
                             bodies=dma.WINDOW_BODIES)
    assert len(rows) == len(dma.BODIES) + len(dma.WINDOW_BODIES)
    assert dma.launches["pd_copy"] > before
    assert {r["body"] for r in rows if r["cluster"]} == {"dma2.k1", "dma4.kJ"}


def test_kulla_conty_bake_on_the_card(tmp_path, monkeypatch):
    """The bake asked for on the card runs there and agrees with the CPU
    bake of the same samples entry by entry (3e-5: the float32 rounding of
    the weights, which nvcc may contract into FMAs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gpu_raytracer_tpu_torch.ops import kulla_conty as kc

    monkeypatch.setattr(kc, "CACHE_DIR", str(tmp_path))
    card = kc.bake_luts(512, "cuda", cache=False)
    host = kc.bake_luts(512, "cpu", cache=False)
    for k in kc.TABLES:
        assert card[k].device.type == "cuda"
        torch.testing.assert_close(card[k].cpu(), host[k], rtol=0, atol=3e-5)


def _moved(make, k, paged=False, **gpu):
    """A Pathtracer on the card that rendered one sample, then had instance
    `k` moved and turned and its tables refreshed (`update`); and a fresh
    one built on the moved scene. `paged`: both under pt_stream's cut
    routing budget, so the refresh re-packs paged tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    import numpy as np

    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.bvh import stream as stream_mod
    from gpu_raytracer_tpu_torch.core import transform as xf
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import buffers as tb

    with pytest.MonkeyPatch.context() as mp:
        if paged:
            mp.setattr(tb, "VMEM_LIMIT", 8 * 1024 * 1024)
            mp.setattr(stream_mod, "PAGE_ROWS", 48)
        scene = make()
        p = Pathtracer(scene, CPUConfig(batch_size=W * W), GPUConfig(**gpu), device="cuda")
        p.init_device()
        p.render()
        inst = scene.instances[k]
        inst.position = inst.position + np.array([0.07, 0.03, -0.05], np.float32)
        inst.rotation = xf.quat_axis_angle([0.0, 1.0, 0.0], 0.4)
        inst.update()
        p.invalidated.scene = True
        p.update()
        fresh = Pathtracer(scene, CPUConfig(batch_size=W * W), GPUConfig(**gpu),
                           device="cuda")
        fresh.init_device()
    return p, fresh


def _qbvh(make):
    def build():
        from gpu_raytracer_tpu_torch import CPUConfig
        from gpu_raytracer_tpu_torch.config import BVHType

        scene = make()
        scene.config = CPUConfig(bvh_type=BVHType.BVH4)
        return scene
    return build


def _scenes():
    from gpu_raytracer_tpu_torch.scenes import cornell_scene, instanced_scene, procedural_scene

    return {"merged": (lambda: procedural_scene(W, W, 4), 2, 3),
            "two_level": (lambda: instanced_scene(W, W), 9, 4),
            "small": (lambda: cornell_scene(W, W), 3, 6),
            "stream": (lambda: procedural_scene(W, W, 4), 2, 3),
            "qbvh_merged": (_qbvh(lambda: procedural_scene(W, W, 4)), 2, 3),
            "qbvh_two_level": (_qbvh(lambda: instanced_scene(W, W)), 9, 4)}


@pytest.mark.parametrize("name", ["merged", "two_level", "small", "stream", "qbvh_merged",
                                  "qbvh_two_level"])
def test_refreshed_tables_kernels_match_plain(name):
    """After a move: the refreshed device tables bit-equal to a fresh
    build's; every kernel of the route against its plain version on a
    captured wave of the refreshed tables; the image by the image bar."""
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import buffers as tb

    make, k, bounces = _scenes()[name]
    p, fresh = _moved(make, k, paged=name == "stream", num_bounces=bounces)
    keys = [key for key in tb.TRANSFORMED_KEYS if key != "inst_prev_rows"]
    assert cs.tables_differ(p.buffers, fresh.buffers, keys) == []
    if name == "small":
        assert p.route() == "binary_shade"
        got = cs.capture_wave(p, W * W, route="binary_shade", every=True)
        for args, _ in got["binary_closest"]:
            cs.compare_binary(DISPATCH.binary_closest(*args), PLAIN.binary_closest(*args))
        for args, _ in got["binary_any"]:
            cs.compare_any(DISPATCH.binary_any(*args), PLAIN.binary_any(*args))
        for args, kw in got["fused_shade"]:
            cs.compare_shade(DISPATCH.fused_shade(*args, **kw),
                             PLAIN.fused_shade(*args, **kw))
    elif name == "stream":
        assert p.route() == "stream"
        got = cs.capture_wave(p, W * W, route="stream", every=True)
        for (tables, o, d, tm), _ in got["stream_closest"]:
            (a, ra), (b, rb) = (DISPATCH.stream_closest(tables, o, d, tm),
                                PLAIN.stream_closest(tables, o, d, tm))
            assert torch.equal(ra, rb)
            cs.compare_stream_closest(a, b, (tables, o, d))
        for (tables, o, d, tm), _ in got["stream_any"]:
            cs.compare_any(DISPATCH.stream_any(tables, o, d, tm),
                           PLAIN.stream_any(tables, o, d, tm))
    else:
        assert p.route() == "wide"
        assert p.buffers["wide"].two_level == name.endswith("two_level")
        got = cs.capture_wave(p, W * W)
        for role in ("primary", "closest", "any"):
            (tables, o, d, tm), _ = got[role]
            a = getattr(DISPATCH, role)(tables, o, d, tm)
            b = getattr(PLAIN, role)(tables, o, d, tm)
            if role == "any":
                cs.compare_any(a, b)
            else:
                cs.compare_closest(a, b, cs.TRI_MATCH_COHERENT if role == "primary"
                                   else cs.TRI_MATCH_INCOHERENT, role == "primary",
                                   (tables, o, d))
    _render_pair(p)


@pytest.mark.parametrize("layout", ["merged", "two_level"])
def test_viewer_query_one_ray_launches_match_plain(pt, pt_tl, layout):
    """The viewer's pixel query launches the primary walk on one ray: each
    one-ray launch of K1 over a grid of pixels against the plain walk on the
    whole grid, by the tie-aware bar; `query_pixel` names the same hit."""
    from gpu_raytracer_tpu_torch.config import ReconstructionFilter
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN
    from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors, generate_primary_rays
    from gpu_raytracer_tpu_torch.utils import viewer

    p = pt if layout == "merged" else pt_tl
    ids = torch.arange(0, W * W, 17, device="cuda")
    o, d = generate_primary_rays(camera_tensors(p.scene.camera.params(), "cuda"), ids, W, 0,
                                 ReconstructionFilter.BOX)
    tables = p.buffers["wide"]
    one = torch.full((1,), float("inf"), device="cuda")
    hits = [p.kernels.primary(tables, o[i:i + 1], d[i:i + 1], one) for i in range(ids.shape[0])]
    a = type(hits[0])(*(None if getattr(hits[0], f) is None
                         else torch.cat([getattr(h, f) for h in hits]) for f in hits[0]._fields))
    b = PLAIN.primary(tables, o, d, torch.full((ids.shape[0],), float("inf"), device="cuda"))
    cs.compare_closest(a, b, cs.TRI_MATCH_COHERENT, True, (tables, o, d))
    for i in (0, ids.shape[0] // 2, ids.shape[0] - 1):
        info = viewer.query_pixel(p, int(ids[i]) % W, int(ids[i]) // W)
        assert (info is None) == bool(a.tri[i] < 0)
        assert info is None or info["t"] == float(a.t[i])


def test_stage_times_on_the_card(pt):
    """stage_times on the card: the wide route's keys, positive times, the
    kernels named by `paths`."""
    from gpu_raytracer_tpu_torch.utils.profiling import stage_times

    times = stage_times(pt, repeats=2)
    assert list(times) == ["generate_ms", "trace_primary_ms", "trace_bounce_ms",
                           "trace_shadow_ms", "full_sample_ms"]
    assert all(v > 0 for v in times.values())
    assert all(v.startswith("cuda:") for v in pt.paths.values())


def test_compacted_render_on_the_card():
    """A compacted b10 wave of a 512x512 merged scene (tiers (2, 4, 16):
    narrow waves of 131,072, 65,536 and 16,384 lanes) equals the
    full-width one bit for bit, with equal ray counts; every closest-hit,
    any-hit and shade call on a narrow wave launched its kernel and ran no
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import (
        DISPATCH,
        Pathtracer,
        kernel_paths,
        render_wave,
    )
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
    from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors, tile_order
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    side = 512
    p = Pathtracer(procedural_scene(side, side, 4), CPUConfig(batch_size=side * side),
                   GPUConfig(), device="cuda")
    p.init_device()
    assert p.route() == "wide" and p.gpu_config.num_bounces == 10
    assert all(v.startswith("cuda:") for v in kernel_paths(DISPATCH, "cuda").values())
    calls = []

    def watched(role, counters):
        fn = getattr(DISPATCH, role)

        def wrapped(*args, **kw):
            before = (sum(counters[0].values()), sum(counters[1].values()))
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            lanes = args[1].shape[0] if role != "shade" else args[2]["alive"].shape[0]
            calls.append((role, lanes, sum(counters[0].values()) - before[0],
                          sum(counters[1].values()) - before[1]))
            return out
        return wrapped

    kernels = DISPATCH._replace(
        closest=watched("closest", (wt.launches, wt.plain_calls)),
        any=watched("any", (wt.launches, wt.plain_calls)),
        shade=watched("shade", (sg.launches, sg.plain_calls)))
    camera = camera_tensors(p.scene.camera.params(), "cuda")
    pix = torch.as_tensor(tile_order(side, side).astype("int64"), device="cuda")
    runs = []
    for tiers in ((), (2, 4, 16)):
        calls.clear()
        log = []
        out, rays = render_wave(p.buffers, camera, pix, 0, p.gpu_config, side, 0, True, True,
                                kernels=kernels, compact_tiers=tiers, bounce_log=log)
        runs.append((out, int(rays), log, list(calls)))
    (full, rays_full, log_full, _), (out, rays, log, narrow_calls) = runs
    assert all(w == side * side for _, _, w in log_full)
    assert any(w < side * side for _, _, w in log), log
    assert torch.equal(out, full) and rays == rays_full
    narrow = [c for c in narrow_calls if c[1] < side * side]
    assert {c[0] for c in narrow} == {"closest", "any", "shade"}, narrow_calls
    assert all(launched >= 1 and plain == 0 for _, _, launched, plain in narrow), narrow
