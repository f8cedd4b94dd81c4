"""K7: the fused beam scan (``csrc/beam_scan.cu``), one launch a batch's
decode with ``DSJAX_FUSED_BEAM=1``."""

from portbench.counts import least_time

COUNTER = ("dsjax_torch.ops.beam", "LAUNCHES")
LAUNCHED_BY = ()


def matches(name: str) -> bool:
    return "beam_kernel" in name


def bound(n_b, n_t, width, classes, valid_frames):
    """An operation per (frame, beam, class) candidate of the valid frames;
    the f32 log-probabilities and sizes in, the four (T, B, W) int32
    histories, the totals, the 7-part carry and the ranking out."""
    bw = n_b * width
    n_bytes = (n_b * n_t * classes * 4 + n_b * 4 + 4 * n_t * bw * 4 + bw * 4
               + (2 * 4 + 5 * 4) * bw + bw * 4 + bw * 4)
    return least_time(float(valid_frames) * width * classes, n_bytes, "float32")
