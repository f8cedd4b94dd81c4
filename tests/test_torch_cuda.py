"""dsjax_torch's CUDA kernel on the card (marked `cuda`; skips without one).

Run on a machine with an NVIDIA card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernel is held against its plain PyTorch version on the same CUDA
tensors (f32: atol 2e-5, rtol 1e-4, sum order only; bf16: atol 3e-2, the
carry rounds to bf16 every step), and the model's CUDA forward against its
CPU forward with TF32 off.
"""

import numpy as np
import pytest
import torch

from dsjax_torch.ops import lstm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=0.0)}


@pytest.fixture
def full_fp32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(12, 8, 128, (False, True)), (7, 3, 64, (False,)),
                                   (33, 20, 256, (True, False))])
def test_kernel_matches_plain_version(full_fp32, dtype, shape):
    T, B, H, reverse = shape
    D = len(reverse)
    rng = np.random.default_rng(T)
    dev = lambda a, dt=dtype: torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)
    lengths = rng.integers(1, T + 1, B)
    lengths[0], lengths[-1] = 1, T
    mask = dev(np.arange(T)[:, None] < lengths[None, :], torch.float32)
    args = (dev(rng.standard_normal((D, T, B, 4 * H)) * 0.3), mask,
            dev(rng.standard_normal((D, 4 * H, H)) * 0.1), dev(rng.standard_normal((D, 4 * H)) * 0.1),
            dev(rng.standard_normal((D, B, H)) * 0.1), dev(rng.standard_normal((D, B, H)) * 0.1))
    before = lstm.LAUNCHES
    out = lstm.lstm_scan(*args, reverse)
    torch.cuda.synchronize()
    assert lstm.LAUNCHES == before + 1
    ref = lstm.lstm_scan_reference(*args, reverse)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.float(), r.float(), **TOL[dtype])


def test_model_cuda_forward_matches_cpu(full_fp32):
    from dsjax_torch.config import BiDirectionalConfig, SpectConfig
    from dsjax_torch.model.ds2 import DeepSpeech2

    cfg = BiDirectionalConfig(hidden_size=64, hidden_layers=3)
    model = DeepSpeech2(29, SpectConfig(), cfg, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 161, 50)).astype(np.float32))
    lengths = torch.tensor([50, 31, 12, 1], dtype=torch.int32)
    with torch.inference_mode():
        want, want_lens, _ = model(x, lengths)
        before = lstm.LAUNCHES
        got, got_lens, carry = model.cuda()(x.cuda(), lengths.cuda())
        torch.cuda.synchronize()
    assert lstm.LAUNCHES == before + cfg.hidden_layers
    assert torch.equal(got_lens.cpu(), want_lens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)
