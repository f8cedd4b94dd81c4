"""K5: the GRU's reverse scan (``csrc/gru_bwd.cu``), one launch a training
layer call."""

from portbench.counts import ESIZE, least_time
from portbench.kernels import scan_sizes

COUNTER = ("dsjax_torch.ops.gru", "BWD_LAUNCHES")
LAUNCHED_BY = (("gru", True),)
GATES = 3


def matches(name: str) -> bool:
    return "gru_bwd_step_kernel" in name


def bound(n_dir, n_t, n_b, n_h, dtype, valid):
    """g_seq (4H), mask, w, h_prev, dy, dh_T -> dxp, dh0."""
    e, g = ESIZE[dtype], GATES
    seq, state, mask = scan_sizes(n_dir, n_t, n_b, n_h)
    n_bytes = mask + n_dir * g * n_h * n_h * e + e * (4 * seq + seq + seq + state + g * seq
                                                      + state)
    return least_time(2.0 * g * n_h * n_h * valid * n_dir, n_bytes, dtype)
