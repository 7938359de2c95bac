"""A flat channel per slot and UE: orthonormal rows over the receive
ports (a random unitary matrix for as many layers as ports, a random
unit-norm row for one layer), by Gram-Schmidt of complex Gaussian draws.
No fading over time or frequency, no delay spread.

A channel module of a configuration's ``channel.kind`` has ``PARAMS``,
the keys of ``channel`` that it reads besides ``kind`` and ``snr_db``;
``draw(gen, n, layers, ports, dev, params)``, n slots' channels as one
complex tensor, linear in amplitude; and ``apply(chan, grid_l)``, the
(B, P, 14, nsc) port grids received through ``chan`` (B slots) from the
(B, nl, 14, nsc) layer grids."""

from __future__ import annotations

import torch

from portbench.reference import link

PARAMS: frozenset = frozenset()


def draw(gen: torch.Generator, n: int, layers: int, ports: int, dev: torch.device,
         params: dict) -> torch.Tensor:
    """(n, layers, ports) complex64 with orthonormal rows."""
    z = torch.randn((n, layers, ports), generator=gen, device=dev, dtype=torch.complex64)
    out = []
    for i in range(layers):
        v = z[:, i]
        for u in out:
            v = v - (u.conj() * v).sum(-1, keepdim=True) * u
        out.append(v / torch.sqrt((v.abs() ** 2).sum(-1, keepdim=True)))
    return torch.stack(out, dim=1)


def apply(chan: torch.Tensor, grid_l: torch.Tensor) -> torch.Tensor:
    return link.precode(grid_l, chan)
