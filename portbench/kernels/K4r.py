"""K4r: the GRU's training forward with residuals (``csrc/gru_fwd.cu``), one
launch a training layer call."""

from portbench.counts import ESIZE, least_time
from portbench.kernels import scan_sizes

COUNTER = ("dsjax_torch.ops.gru", "RESIDUAL_LAUNCHES")
LAUNCHED_BY = (("gru", True),)
GATES = 3


def matches(name: str) -> bool:
    return "gru_residual_step_kernel" in name


def bound(n_dir, n_t, n_b, n_h, dtype, valid):
    """xp, mask, w, b, h0 -> y, h_T, gates (4H)."""
    e, g = ESIZE[dtype], GATES
    seq, state, mask = scan_sizes(n_dir, n_t, n_b, n_h)
    n_bytes = mask + n_dir * g * n_h * n_h * e + e * (g * seq + n_dir * g * n_h + state
                                                      + seq + state)
    n_bytes += e * 4 * seq
    return least_time(2.0 * g * n_h * n_h * valid * n_dir, n_bytes, dtype)
