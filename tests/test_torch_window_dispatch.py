"""Which instantiation of ``csrc/window_attn.cu`` a launch of K3, K5 or K7
takes: ``ops.window_attn.window_kernel_plan`` is a rule on shapes alone, so
it is held here on the CPU. bf16 at HTSAT's four stage shapes goes to the
tensor-core kernels; fp32 (whose fixtures TF32 would break) and every other
shape to the FMA kernel; what neither takes is refused with the messages the
card-only ``test_window_kernels_refuse_what_they_do_not_take`` expects. The
CPU route of the wrappers takes no kernel and raises neither count.
"""

import numpy as np
import pytest
import torch

from zs_aac_tpu_torch.ops import window_attn as wa

# HTSAT (embed 96, heads (4, 8, 16, 32), window 8, spec 256): (H = W, C, heads)
HTSAT_STAGES = {"stage1": (64, 96, 4), "stage2": (32, 192, 8), "stage3": (16, 384, 16),
                "stage4": (8, 768, 32)}


@pytest.mark.parametrize("mlp", [True, False], ids=["block", "attention"])
@pytest.mark.parametrize("stage", sorted(HTSAT_STAGES))
def test_htsat_bf16_stages_take_the_tensor_cores(stage, mlp):
    H, C, heads = HTSAT_STAGES[stage]
    plan = wa.window_kernel_plan(torch.bfloat16, 64, C, C // heads, 4 * C if mlp else None)
    assert plan[0] == "tc"
    _, wpb, split = plan
    # two windows a block where two windows' tiles fit; the chain of kernels
    # that splits a window's heads and columns over blocks only at C = 768
    assert wpb == (2 if C <= 192 else 1)
    assert split == (C == 768)
    # a block is (64 * wpb / 16) row tiles x (C / 96) column groups of warps
    # (4 groups a block when split): at most 16 warps
    assert 4 * wpb * min(C // 96, 4) <= 16


@pytest.mark.parametrize("stage", sorted(HTSAT_STAGES))
def test_fp32_keeps_the_fma_kernel(stage):
    H, C, heads = HTSAT_STAGES[stage]
    assert wa.window_kernel_plan(torch.float32, 64, C, C // heads, 4 * C) == ("fma",)
    assert wa.window_kernel_plan(torch.float32, 64, C, C // heads) == ("fma",)


@pytest.mark.parametrize("N,C,d,hidden", [
    (16, 32, 8, 128),       # 4x4 windows (the tiny HTSAT of the fixtures)
    (16, 16, 8, 64),
    (64, 128, 32, 8192),    # head dim 32
    (64, 96, 48, 384),      # head dim 48
    (64, 288, 24, 1152),    # C = 3 x 96: no stage of HTSAT
    (64, 96, 24, 200),      # a hidden width the chunks do not divide
    (32, 96, 24, 384),      # half a window
], ids=["4x4-C32", "4x4-C16", "d32", "d48", "C288", "hidden200", "N32"])
def test_other_bf16_shapes_take_the_fma_kernel(N, C, d, hidden):
    assert wa.window_kernel_plan(torch.bfloat16, N, C, d, hidden) == ("fma",)


@pytest.mark.parametrize("dtype,N,C,d,error,match", [
    (torch.float32, 64, 192, 96, ValueError, "head dim"),
    (torch.bfloat16, 64, 192, 96, ValueError, "head dim"),
    (torch.bfloat16, 36, 96, 24, ValueError, "tokens per window"),
    (torch.bfloat16, 256, 96, 24, ValueError, "tokens per window"),
    (torch.float16, 64, 96, 24, TypeError, "dtype"),
], ids=["fp32-d96", "bf16-d96", "6x6", "16x16", "fp16"])
def test_plan_refuses_what_neither_kernel_takes(dtype, N, C, d, error, match):
    with pytest.raises(error, match=match):
        wa.window_kernel_plan(dtype, N, C, d)


def test_wrappers_refuse_a_head_dim_of_96_before_any_launch():
    """The wrapper's own check of the geometry raises the same message."""
    x = torch.zeros(1, 8, 8, 192)
    with pytest.raises(ValueError, match="head dim"):
        wa._geometry("fused_window_attention", x, 8, 2, 0)
    assert wa._geometry("fused_window_attention", x.bfloat16(), 8, 8, 0) == (1, 8, 8, 192, 64, 24)


def test_cpu_route_raises_no_count():
    """On CPU tensors the wrappers take the plain versions: neither the
    launch count nor the tensor-core count moves, whatever the shape."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32)).bfloat16()
    C, heads = 96, 4
    x = f(1, 8, 8, C)
    w = [f(C) + 1, f(C), f(C, 3 * C), f(3 * C), f(C, C), f(C), f(C) + 1, f(C),
         f(C, 4 * C), f(4 * C), f(4 * C, C), f(C)]
    bias = torch.zeros(1, 1, heads, 64, 64)
    fns = (wa.fused_swin_block, wa.fused_window_attention, wa.fused_swin_block_train)
    before = [(fn.launches, fn.tc_launches) for fn in fns]
    out = wa.fused_swin_block(x, *w, bias, 8, heads, 0, 1e-6)
    att = wa.fused_window_attention(x, *w[2:6], bias, 8, heads, 0)
    keep = torch.ones(1)
    tr = wa.fused_swin_block_train(x, *w, bias, keep, keep, 8, heads, 0, 1e-6)
    assert [(fn.launches, fn.tc_launches) for fn in fns] == before
    assert out.shape == att.shape == tr.shape == x.shape
    # keep scales of 1: the train block is the eval block
    assert torch.equal(out, tr)
