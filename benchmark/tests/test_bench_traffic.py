"""The generator's records for the check are copies: a program that
updates its filter history, TAA frame and AOV images in place is judged
on what each frame read and made."""

from types import SimpleNamespace

import torch

from benchmark.harness.traffic import Loop


class InPlace:
    """A denoised program that reuses every buffer from frame to frame."""

    def __init__(self):
        self.device = torch.device("cpu")
        self.scene = SimpleNamespace(camera=SimpleNamespace(update=lambda delta: None))
        self.svgf_history = (torch.zeros(2), torch.zeros(2))
        self._taa_prev = torch.zeros(2)
        self.sample_index = 0
        self._aovs = {"depth": torch.zeros(2)}
        self._colour = torch.zeros(2)

    def trace_aovs(self):
        self._aovs["depth"].fill_(self.sample_index + 1.0)
        return self._aovs, 0, 0

    def render_frame_denoised(self):
        frame, _, _ = self.trace_aovs()
        self._colour.copy_(frame["depth"] * 10.0)
        for x in self.svgf_history:
            x.add_(1.0)
        self._taa_prev.add_(1.0)
        self.sample_index += 1
        return self._colour


def test_recorded_frames_are_copies():
    p = InPlace()
    loop = Loop(p, {"mode": "denoised", "warm_units": 3})
    loop.warm()
    frames = loop.recorded_frames(2)
    assert [f["sample_index"] for f in frames] == [3, 4]
    assert [float(f["history"][0][0]) for f in frames] == [3.0, 4.0]
    assert [float(f["taa_prev"][0]) for f in frames] == [3.0, 4.0]
    assert [float(f["aovs"]["depth"][0]) for f in frames] == [4.0, 5.0]
    assert [float(f["colour"][0]) for f in frames] == [40.0, 50.0]
    assert p.trace_aovs.__func__ is InPlace.trace_aovs
