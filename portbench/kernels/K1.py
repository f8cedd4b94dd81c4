"""K1: the LSTM's persistent forward without residuals (``csrc/lstm_fwd.cu``
on ``csrc/scan_persist.cuh``), one launch an evaluation layer call."""

from portbench.counts import ESIZE, least_time
from portbench.kernels import scan_sizes

COUNTER = ("dsjax_torch.ops.lstm", "LAUNCHES")
LAUNCHED_BY = (("lstm", False),)
GATES = 4


def matches(name: str) -> bool:
    return "persistent_scan" in name and "grucell" not in name


def bound(n_dir, n_t, n_b, n_h, dtype, valid):
    """xp, mask, w, b, h0, c0 -> y, h_T, c_T."""
    e, g = ESIZE[dtype], GATES
    seq, state, mask = scan_sizes(n_dir, n_t, n_b, n_h)
    n_bytes = mask + n_dir * g * n_h * n_h * e + e * (g * seq + n_dir * g * n_h + 2 * state
                                                      + seq + 2 * state)
    return least_time(2.0 * g * n_h * n_h * valid * n_dir, n_bytes, dtype)
