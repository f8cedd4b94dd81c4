"""The GRU cell: ``torch.nn.GRU``'s reset, update and new gates, the reset
applied to the recurrent product with its bias, carrying h."""

import torch

MODULE = torch.nn.GRU
GATES = 3
CARRIES = 1


def update(x_t, hp, carries):
    (h,) = carries
    xr, xz, xn = x_t.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return ((1 - z) * n + z * h,)
