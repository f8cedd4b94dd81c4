"""K3: the LSTM's reverse scan (``csrc/lstm_bwd.cu``: in bf16 one resident
cooperative launch, in f32 the per-step kernel), one call a training layer
call."""

from portbench.counts import ESIZE, least_time
from portbench.kernels import scan_sizes

COUNTER = ("dsjax_torch.ops.lstm", "BWD_LAUNCHES")
LAUNCHED_BY = (("lstm", True),)
GATES = 4


def matches(name: str) -> bool:
    return "lstm_bwd_step_kernel" in name


def bound(n_dir, n_t, n_b, n_h, dtype, valid):
    """g_seq, mask, w, c0, c_seq, dy, dh_T, dc_T -> dg, dh0, dc0."""
    e, g = ESIZE[dtype], GATES
    seq, state, mask = scan_sizes(n_dir, n_t, n_b, n_h)
    n_bytes = mask + n_dir * g * n_h * n_h * e + e * (g * seq + state + seq + seq + 2 * state
                                                      + g * seq + 2 * state)
    return least_time(2.0 * g * n_h * n_h * valid * n_dir, n_bytes, dtype)
