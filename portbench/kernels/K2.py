"""K2: the LSTM's training forward with residuals (``csrc/lstm_fwd.cu``), one
launch a training layer call."""

from portbench.counts import ESIZE, least_time
from portbench.kernels import scan_sizes

COUNTER = ("dsjax_torch.ops.lstm", "RESIDUAL_LAUNCHES")
LAUNCHED_BY = (("lstm", True),)
GATES = 4


def matches(name: str) -> bool:
    return "lstm_residual_step_kernel" in name


def bound(n_dir, n_t, n_b, n_h, dtype, valid):
    """xp, mask, w, b, h0, c0 -> y, h_T, c_T, gates, c_seq."""
    e, g = ESIZE[dtype], GATES
    seq, state, mask = scan_sizes(n_dir, n_t, n_b, n_h)
    n_bytes = mask + n_dir * g * n_h * n_h * e + e * (g * seq + n_dir * g * n_h + 2 * state
                                                      + seq + 2 * state)
    n_bytes += e * (g * seq + seq)
    return least_time(2.0 * g * n_h * n_h * valid * n_dir, n_bytes, dtype)
