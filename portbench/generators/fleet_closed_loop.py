"""A fleet of B controllers in a closed loop, made on the device from the seed.

Mix parameters (a traffic file): ``batch``; ``x0_std``, the spread of the
initial states; ``ref_amp_std`` and ``ref_hz``, the amplitude spread and
frequency of each instance's sinusoid reference (one amplitude a
coordinate, one uniform phase an instance, shifted by one dt each step:
the reference's ``model_control_example.cpp:60-68``); ``noise_std``, the
measurement noise added to the predicted state each step.

Each step's measured state is the previous plan's X[:, 1] (where the
instance's last solve failed, its previous state) plus noise, so the loop
is closed through the solver.  The same seed gives the same initial
states, references and noise draws.
"""

from __future__ import annotations

import math

import torch


class FleetClosedLoop:
    def __init__(self, mix: dict, nx: int, N: int, dt: float, seed: int,
                 device, dtype=torch.float32):
        self.B, self.nx, self.N, self.dt = int(mix["batch"]), nx, N, dt
        self.noise_std = float(mix["noise_std"])
        self.dtype = dtype
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        kw = dict(generator=self.gen, dtype=dtype, device=device)
        B = self.B
        self.x0 = float(mix["x0_std"]) * torch.randn(B, nx, **kw)
        self.amp = float(mix["ref_amp_std"]) * torch.randn(B, 1, nx, **kw)
        self.phase = 2.0 * math.pi * torch.rand(B, 1, 1, **kw)
        self.omega = 2.0 * math.pi * float(mix["ref_hz"])
        # the horizon's times (j + 1) dt, in float64 so that k dt stays exact
        self.tgrid = torch.arange(1, N + 1, dtype=torch.float64,
                                  device=device) * dt

    def reference(self, k: int, rows=None) -> torch.Tensor:
        """x_des of step k (B, N, nx), or of the instances ``rows``."""
        arg = (self.omega * (self.tgrid + k * self.dt)).to(self.dtype)
        amp, phase = self.amp, self.phase
        if rows is not None:
            amp, phase = amp[rows], phase[rows]
        return amp * torch.sin(arg[None, :, None] + phase)

    def next_state(self, x_prev, X1, ok) -> torch.Tensor:
        """The measured state after a step: the plan's X[:, 1] where the
        instance's solve was kept, else its previous state; plus noise."""
        x = torch.where(ok[:, None], X1, x_prev)
        return x + self.noise_std * torch.randn(
            x.shape, generator=self.gen, dtype=x.dtype, device=x.device)


def make(mix: dict, nx: int, N: int, dt: float, seed: int, device):
    return FleetClosedLoop(mix, nx, N, dt, seed, device)
