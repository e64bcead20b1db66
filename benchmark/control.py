#!/usr/bin/env python3
"""Readings that set the limits of `correct` (benchmark/harness/check.py):
the control and the planted faults, at a cell's own size, on several seeds.

    python3 benchmark/control.py --workload <cell> --seconds <s> --what <what> --seeds <n> ...

`--what`:
  control          the plain reference put in the program's place and run
                   in bfloat16, the precision below the float32 that the
                   configurations state: `ReferenceProgram` renders the
                   window's samples (or frames, with its own SVGF + TAA)
                   through the same loop, and the float32 reference
                   judges its output as it judges the port's;
  sound            the port as the benchmark runs it (the lower readings);
  <fault>          the port with a fault of benchmark/harness/faults.py
                   planted under the timed path.

Prints one JSON line a seed with the numbers compared and `correct`. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class _Camera:
    def __init__(self, position):
        self.position = position

    def update(self, delta: float) -> None:
        pass


class _Scene:
    def __init__(self, position):
        self.camera = _Camera(position)


class ReferenceProgram:
    """The reference in the program's place, in `dtype`: the calls and
    state that the loop and the check read of the port's Pathtracer."""

    def __init__(self, config: dict, traffic: dict, data, seed: int, device: str,
                 dtype=None):
        import torch

        self.data, self.traffic = data, traffic
        self.device = torch.device(device)
        self.dtype = dtype or torch.bfloat16
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) ^ 0x5EED)
        self.scene = _Scene(data.camera["position"].copy())
        self.bounces = int(traffic["bounces"])
        self.chunk = int(traffic["check"]["chunk"])
        self.magenta_pixels = 0
        self.svgf_history = self._taa_prev = None
        self.sample_index = 0

    def init_device(self) -> None:
        from benchmark.harness import scene as scene_mod
        from benchmark.reference import pathtrace as ref

        self.rs = ref.RefScene(scene_mod.world_triangles(self.data), self.device, self.dtype)
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        import torch

        self.sample_index = 0
        self.accumulator = torch.zeros((self.data.width * self.data.height, 3),
                                       device=self.device)

    def _basis(self):
        from benchmark.harness import scene as scene_mod

        cam = dict(self.data.camera, position=self.scene.camera.position)
        return scene_mod.camera_basis(cam, self.data.width, self.data.height)

    def _pixels(self, jitter, aovs: bool):
        """One path a pixel, chunk by chunk -> (W*H, 3) radiance or AOVs."""
        import torch

        from benchmark.reference import pathtrace as ref

        W, H = self.data.width, self.data.height
        basis, out = self._basis(), []
        for s in range(0, W * H, self.chunk):
            p = torch.arange(s, min(s + self.chunk, W * H), device=self.device)
            if jitter is None:
                jx, jy = ref.gaussian_jitter(p.numel(), self.gen, self.device)
            else:
                jx, jy = jitter
            o, d = ref.camera_rays(basis, (p % W).double() + jx, (p // W).double() + jy,
                                   self.dtype)
            out.append(ref.radiance(self.rs, o, d, self.bounces, self.gen, aovs=aovs))
        if not aovs:
            return torch.cat([L for L, _ in out])
        return {k: torch.cat([o[k] for o in out]) for k in out[0]}

    def render(self) -> None:
        L = self._pixels(None, False)
        self.accumulator = self.accumulator + (L - self.accumulator) / (self.sample_index + 1)
        self.sample_index += 1

    def trace_aovs(self):
        from benchmark.harness.check import TAA_HALTON

        H, W = self.data.height, self.data.width
        g = self._pixels(TAA_HALTON[self.sample_index & 3], True)
        direct = g["direct"]
        frame = {"direct": direct, "indirect": (g["radiance"] - direct).clamp(min=0.0),
                 "albedo": g["albedo"], "normal": g["normal"], "depth": g["depth"],
                 "instance": g["instance"], "position_prev": g["position"]}
        frame = {k: (v.to(self.dtype) if v.is_floating_point() else v).reshape(
            (H, W) + tuple(v.shape[1:])) for k, v in frame.items()}
        return frame, 0, 0

    def render_frame_denoised(self):
        import torch

        from benchmark.reference import svgf as ref_svgf

        H, W = self.data.height, self.data.width
        vp = torch.as_tensor(ref_svgf.view_projection(self.data.camera, self.scene.camera.position,
                                                      W, H), device=self.device)
        if self.svgf_history is None:
            z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)  # noqa: E731
            self.svgf_history = ref_svgf.History(
                z(H, W, 3), z(H, W, 3), z(H, W, 4), z(H, W), z(H, W, 3),
                torch.full((H, W), float("inf"), dtype=self.dtype, device=self.device),
                torch.full((H, W), -1, dtype=torch.int32, device=self.device))
            self._taa_prev = z(H, W, 3)
            self._vp_prev = vp
        frame, _, _ = self.trace_aovs()
        colour, self.svgf_history, self._taa_prev = ref_svgf.denoise(
            frame, self.svgf_history, self._taa_prev, self._vp_prev.to(self.dtype),
            self.sample_index == 0, ref_svgf.settings_of(self.traffic.get("gpu", {})))
        self.sample_index += 1
        self._vp_prev = vp
        return colour.float()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--what", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark import run
    from benchmark.harness import faults

    for seed in args.seeds:
        kw = {}
        if args.what == "control":
            kw["make_program"] = ReferenceProgram
        elif args.what != "sound":
            kw["plant"] = faults.FAULTS[args.what]
        out = run.run_cell(ROOT, args.workload, seed, args.seconds, False, device=args.device,
                           **kw)
        r = out["result"]
        print(json.dumps({"what": args.what, "workload": args.workload, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "numbers": {k: v for k, v, _ in out["limits"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
