"""Headless batch render with the PyTorch/CUDA port.

    python -m gpu_raytracer_tpu_torch scene.xml -N 64 -o out.exr [--device cuda]

Takes the JAX package's CLI flags (args.py, this package's copy of
gpu_raytracer_tpu/args.py) plus `--device` (default `cuda`). `--svgf on`
renders -N denoised 1-spp frames (SVGF + TAA, history carried from frame to
frame) and writes the last one. `-I ao` renders ambient occlusion
(integrators/ao.py) instead of paths; `--aovs` also writes the albedo,
normal and position AOVs beside the output (`<out>_albedo.exr`, ...;
Pathtracer.export_aovs). `--perf` runs the POV sweep of utils/perftest.py
and writes perf.txt (the scene's POVs where its name matches a table, else
the Sponza ones). `--checkpoint FILE` saves the running mean every
`--checkpoint-every` seconds and resumes from it when the render
configuration and resolution match (not under `--svgf on`, whose history is
no running mean); the file is removed when the render completes. `--viewer`
runs the terminal viewer (utils/viewer.py) on the same integrator; with
stdin not a terminal it prints frames until -N samples are rendered.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from gpu_raytracer_tpu_torch import args as cli
from gpu_raytracer_tpu_torch.config import IntegratorType
from gpu_raytracer_tpu_torch.scene import Scene
from gpu_raytracer_tpu_torch.utils import image as image_io


def _split_device(argv):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    return ns.device, rest


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device, rest = _split_device(argv)
    cpu, gpu = cli.parse(rest)
    if not cpu.scene_filenames:
        print("no scene file given (see --help)", file=sys.stderr)
        return 2
    ao = cpu.integrator == IntegratorType.AO
    if ao and gpu.enable_svgf:
        raise ValueError("-I ao renders no denoised frames; drop --svgf on")
    if ao:
        from gpu_raytracer_tpu_torch.integrators.ao import AO as Integrator
    else:
        from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer as Integrator

    t0 = time.time()
    scene = Scene.from_config(cpu)
    if "-W" in rest or "--width" in rest:
        scene.film_width = cpu.initial_width
    if "-H" in rest or "--height" in rest:
        scene.film_height = cpu.initial_height
    scene.camera.resize(scene.film_width, scene.film_height)
    print(f"[scene] {len(scene.instances)} instances, {scene.triangle_count()} "
          f"triangles, {scene.film_width}x{scene.film_height} "
          f"({time.time() - t0:.2f}s)")

    t0 = time.time()
    integrator = Integrator(scene, cpu, gpu, device=device)
    integrator.init_device()
    print(f"[init] tables built in {time.time() - t0:.2f}s on {device}")
    print(f"[paths] {integrator.paths}")

    if cpu.run_viewer:
        from gpu_raytracer_tpu_torch.utils.viewer import run_viewer

        run_viewer(integrator, target_samples=cpu.output_sample_index or 0)
        return 0

    if cpu.run_perf_test:
        from gpu_raytracer_tpu_torch.utils import perftest

        povs = (perftest.povs_for_scene(" ".join(cpu.scene_filenames))
                or perftest.POVS_SPONZA)
        perftest.run(integrator, povs)
        print("[perf] wrote perf.txt")
        return 0

    num_samples = cpu.output_sample_index or 16
    ckpt = _Checkpoint(cpu, gpu, scene, integrator)
    ckpt.resume(num_samples)
    t0 = time.time()
    last_save = t0
    start_index = integrator.sample_index
    step = integrator.render_frame_denoised if gpu.enable_svgf else integrator.render
    while integrator.sample_index < num_samples:
        step()
        if (ckpt.path and time.time() - last_save >= cpu.checkpoint_interval_s
                and integrator.sample_index < num_samples):
            ckpt.save()
            last_save = time.time()
    if integrator.device.type == "cuda":
        torch.cuda.synchronize(integrator.device)
    dt = time.time() - t0
    rendered = max(num_samples - start_index, 1)
    what = "denoised frames" if gpu.enable_svgf else "spp"
    print(f"[render] {rendered} {what} in {dt:.2f}s "
          f"({1000.0 * dt / rendered:.1f} ms each, "
          f"{integrator.rays_traced} rays)")
    if hasattr(integrator, "compaction"):
        # The late-bounce compaction's tiers and the first wave's bounces.
        print(f"[compaction] {integrator.compaction}")
    if ckpt.path and os.path.exists(ckpt.path):
        os.remove(ckpt.path)  # the render completed: the snapshot is stale
    if cpu.output_filename:
        image_io.save(cpu.output_filename, integrator.framebuffer())
        print(f"[output] wrote {cpu.output_filename}")
        if cpu.export_aovs and hasattr(integrator, "export_aovs"):
            for name, path in integrator.export_aovs(cpu.output_filename).items():
                print(f"[output] wrote {path} ({name})")
    return 0


class _Checkpoint:
    """The running mean's snapshot (JAX __main__.py:69-138): a fingerprint
    of the render configuration, resume where it and the resolution match,
    an atomic save (`.tmp.npz`, then `os.replace`). Off under SVGF."""

    def __init__(self, cpu, gpu, scene, integrator):
        self.path = cpu.checkpoint_filename
        self.integrator = integrator
        self.fingerprint = repr((sorted(cpu.scene_filenames), scene.film_width,
                                 scene.film_height, cpu.integrator.value, cpu.seed, gpu))
        self.pixels = scene.film_width * scene.film_height
        if self.path and gpu.enable_svgf:
            print("[checkpoint] SVGF mode keeps filter history, not a running "
                  "mean; checkpointing is disabled for it")
            self.path = None

    def resume(self, num_samples: int) -> None:
        import numpy as np

        if not (self.path and os.path.exists(self.path)):
            return
        snap = np.load(self.path, allow_pickle=False)
        it = self.integrator
        if str(snap["fingerprint"]) != self.fingerprint:
            print(f"[checkpoint] {self.path} was taken under a different render "
                  f"configuration; ignoring it")
        elif snap["accumulator"].shape != (self.pixels, 3):
            print(f"[checkpoint] {self.path} resolution mismatch; ignoring it")
        else:
            it.accumulator = torch.as_tensor(snap["accumulator"], device=it.device)
            it.sample_index = int(snap["sample_index"])
            print(f"[checkpoint] resumed {self.path} at sample "
                  f"{it.sample_index}/{num_samples}")

    def save(self) -> None:
        import numpy as np

        it = self.integrator
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, accumulator=it.accumulator.cpu().numpy(),
                 sample_index=it.sample_index, fingerprint=self.fingerprint)
        os.replace(tmp, self.path)
        print(f"[checkpoint] saved {self.path} at sample {it.sample_index}")


if __name__ == "__main__":
    sys.exit(main())
