"""K4: the GRU's persistent forward without residuals (``csrc/gru_fwd.cu`` on
``csrc/scan_persist.cuh``), one launch an evaluation layer call."""

from portbench.counts import ESIZE, least_time
from portbench.kernels import scan_sizes

COUNTER = ("dsjax_torch.ops.gru", "LAUNCHES")
LAUNCHED_BY = (("gru", False),)
GATES = 3


def matches(name: str) -> bool:
    return "persistent_scan" in name and "grucell" in name


def bound(n_dir, n_t, n_b, n_h, dtype, valid):
    """xp, mask, w, b, h0 -> y, h_T."""
    e, g = ESIZE[dtype], GATES
    seq, state, mask = scan_sizes(n_dir, n_t, n_b, n_h)
    n_bytes = mask + n_dir * g * n_h * n_h * e + e * (g * seq + n_dir * g * n_h + state
                                                      + seq + state)
    return least_time(2.0 * g * n_h * n_h * valid * n_dir, n_bytes, dtype)
