"""Faults planted under the timed path, to show that the check catches
them (benchmark/tests/test_bench_faults.py on the CPU, benchmark/control.py
on the GPU). Each `plant(program)` breaks the port's Pathtracer, or the
wave function of its module, and returns a function that undoes it. The
cells run on one GPU, so there is no exchange between GPUs to leave out.

  state_unchanged  a step returns with the state as it was: `render()`
                   leaves the accumulation alone; a denoised frame's
                   filter history and TAA frame are not advanced;
  half_batch       every other lane of each wave is left out of the trace
                   and the rest carries twice its radiance, so the image's
                   mean is kept;
  altered          the first half of each wave's lanes leave the wave with
                   twice their radiance.
"""

from __future__ import annotations


def _wrap_render_wave(change):
    """Replace the port's `render_wave` (looked up in its module by
    `Pathtracer._trace`) by `change(original)`; -> undo."""
    from gpu_raytracer_tpu_torch.integrators import pathtracer

    original = pathtracer.render_wave
    pathtracer.render_wave = change(original)

    def undo():
        pathtracer.render_wave = original
    return undo


def _scale(out, factor):
    """Multiply a wave's radiance (and its direct and indirect AOVs) by
    `factor`, a tensor broadcasting over the lanes."""
    if isinstance(out, dict):
        return {k: (v * factor[:, None] if k in ("radiance", "direct", "indirect") else v)
                for k, v in out.items()}
    return out * factor[:, None]


def state_unchanged(program):
    if not program.gpu_config.enable_svgf:
        render = program.render
        program.render = lambda: None

        def undo():
            program.render = render
        return undo
    denoise = program.denoise

    def stale(frame):
        history, taa = program.svgf_history, program._taa_prev
        colour = denoise(frame)
        program.svgf_history, program._taa_prev = history, taa
        return colour

    program.denoise = stale

    def undo():
        program.denoise = denoise
    return undo


def half_batch(program):
    import torch

    def change(render_wave):
        def wave(buffers, camera, pixel_index, *args, valid_mask=None, **kw):
            R = pixel_index.shape[0]
            keep = torch.arange(R, device=pixel_index.device) % 2 == 0
            mask = keep if valid_mask is None else valid_mask.to(keep.device).bool() & keep
            out, n = render_wave(buffers, camera, pixel_index, *args, valid_mask=mask, **kw)
            return _scale(out, torch.where(keep, 2.0, 0.0)), n
        return wave
    return _wrap_render_wave(change)


def altered(program):
    import torch

    def change(render_wave):
        def wave(buffers, camera, pixel_index, *args, **kw):
            out, n = render_wave(buffers, camera, pixel_index, *args, **kw)
            R = pixel_index.shape[0]
            lanes = torch.arange(R, device=pixel_index.device)
            return _scale(out, torch.where(lanes < R // 2, 2.0, 1.0)), n
        return wave
    return _wrap_render_wave(change)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "altered": altered}
