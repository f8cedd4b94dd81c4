"""The LSTM cell: ``torch.nn.LSTM``'s gates i, f, g, o, carrying h and c."""

import torch

MODULE = torch.nn.LSTM
GATES = 4
CARRIES = 2


def update(x_t, hp, carries):
    _, c = carries
    i, f, g, o = (x_t + hp).chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new
