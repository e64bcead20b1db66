"""The one general generator: drives the program as a traffic mix's data
file says. Both modes are closed loops: the next call starts when the last
one has returned and the device has synchronised.

  batch     the offline `-N` render: `render()` back to back, one sample
            of every pixel a call, accumulating over the window;
  denoised  the interactive preview: one `render_frame_denoised()` a frame,
            the camera held at the configuration's pose (the reference's
            PerfTest holds each of its poses still for its frames).

`program` is the port's `Pathtracer`, or anything with the same calls
(the control puts the reference in its place).
"""

from __future__ import annotations

import time

MODES = ("batch", "denoised")


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _copy(x):
    """A copy on the device of a tensor, or of the tensors in a tuple,
    named tuple, list or dict."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_copy, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(_copy, x))
    return x


class Loop:
    """Runs one cell's traffic on `program`: `warm()`, `window(seconds)`,
    `step()` (one more unit, for the traced slice), and, for the check,
    `recorded_frames(n)`."""

    def __init__(self, program, traffic: dict):
        if traffic["mode"] not in MODES:
            raise ValueError(f"traffic mode {traffic['mode']!r}: want one of {MODES}")
        self.program, self.traffic = program, traffic
        self.mode = traffic["mode"]
        self.device = program.device
        self.times_s: list = []   # each window unit, start to sync
        self.samples = 0          # batch: render() calls since the last reset

    def step(self):
        p = self.program
        if self.mode == "batch":
            p.render()
            self.samples += 1
            out = None
        else:
            p.scene.camera.update(0.0)
            out = p.render_frame_denoised()
        _sync(self.device)
        return out

    def warm(self) -> None:
        for _ in range(int(self.traffic["warm_units"])):
            self.step()
        if self.mode == "batch":
            self.program.reset_accumulation()
            self.samples = 0

    def window(self, seconds: float) -> float:
        """Run units until `seconds` have passed; -> the window's wall
        seconds, from its start to the last unit's synchronize."""
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            self.step()
            b = time.perf_counter()
            self.times_s.append(b - a)
            if b - t0 >= seconds:
                return b - t0

    def recorded_frames(self, n: int) -> list:
        """Denoised: run `n` more frames, untimed, through the same entry
        and keep copies of each one's state before it (filter history, TAA
        frame, sample index), of the AOV images its trace half made and of
        the frame it returned, for the check. Copies, so that a program
        that updates its buffers in place is judged on what it read."""
        p = self.program
        trace = p.trace_aovs
        seen = {}

        def trace_aovs():
            out = trace()
            seen["aovs"] = _copy(out[0])
            return out

        p.trace_aovs = trace_aovs
        frames = []
        try:
            for _ in range(n):
                before = {"history": _copy(p.svgf_history), "taa_prev": _copy(p._taa_prev),
                          "sample_index": p.sample_index}
                colour = self.step()
                frames.append(dict(before, aovs=seen.pop("aovs"), colour=colour.clone()))
        finally:
            p.trace_aovs = trace
        return frames
