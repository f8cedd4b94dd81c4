"""K8's plan (dsjax_torch/ops/mm_chain.py:chain_plan) on the CPU: the CTAs,
the rows of the step product and where h stays, checked again by the
kernel (csrc/mm_chain.cu:make_plan), and the shapes it refuses. The
kernel itself runs only on a card (tests/test_torch_cuda.py); its plain
version is held against the Pallas chain in tests/test_torch_gru.py.
"""

import pytest

from dsjax_torch.ops._card import SMEM_LIMIT
from dsjax_torch.ops.mm_chain import ChainPlan, chain_plan

SMS = 132    # an H100 SXM


@pytest.mark.parametrize("b,h,want", [
    # h resident: one buffer of 64 rows a K atom beside W's 64 KB slice
    (16, 1024, ChainPlan(ctas=128, cols=32, m_rows=64, stages=16, resident=1,
                         smem_bytes=1024 + 16 * 4096 + 20 * 8 + 16 * 8192)),
    (64, 1024, ChainPlan(ctas=128, cols=32, m_rows=64, stages=16, resident=1,
                         smem_bytes=1024 + 16 * 4096 + 20 * 8 + 16 * 8192)),
    # two m64 tiles: 16 atoms of 16 KB do not fit beside W; a ring of 10
    (128, 1024, ChainPlan(ctas=128, cols=32, m_rows=128, stages=10, resident=0,
                          smem_bytes=1024 + 16 * 4096 + 20 * 8 + 10 * 16384)),
    # a partial atom (H = 32) rounds up to a unit of 4 atoms
    (16, 32, ChainPlan(ctas=4, cols=32, m_rows=64, stages=4, resident=1,
                       smem_bytes=1024 + 4 * 4096 + 20 * 8 + 4 * 8192)),
    # the widest H on 132 SMs: 17 atoms round up to 20
    (64, 1056, ChainPlan(ctas=132, cols=32, m_rows=64, stages=18, resident=0,
                         smem_bytes=1024 + 20 * 4096 + 20 * 8 + 18 * 8192)),
])
def test_chain_plan(b, h, want):
    plan = chain_plan(b, h, SMS)
    assert plan == want
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.ctas * plan.cols == 4 * h


@pytest.mark.parametrize("b,h,sms,match", [
    (64, 1088, SMS, "136 CTAs"),            # 4H / 32 CTAs, one an SM
    (64, 1024, 100, "100 SMs"),             # a card of fewer SMs
    (144, 1024, SMS, "batch 144"),          # past two m64 tiles
    (24, 1024, SMS, "batch 24"),            # not a multiple of 16
    (64, 1000, SMS, "hidden size 1000"),    # not a multiple of 16
])
def test_chain_plan_refuses(b, h, sms, match):
    with pytest.raises(ValueError, match=match):
        chain_plan(b, h, sms)
