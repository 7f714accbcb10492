"""Which instantiation of ``csrc/window_attn.cu`` a launch of K3, K5 or K7
takes, which per-token kernels of ``csrc/swin_train.cu`` a launch of K8 or
of K9 (and K6) takes and which split-token weight-gradient kernel a product
of K6, K8 or K9 takes: ``ops.window_attn.window_kernel_plan``,
``mlp_bwd_plan``, ``attn_bwd_plan`` and ``wgrad_plan`` are rules on shapes
alone, so they are held here on the CPU. bf16 at HTSAT's stage shapes goes to
the tensor-core kernels; fp32 (whose fixtures TF32 would break) and every other
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


# -- the train backward: K8's per-token kernel and the weight-gradient product ----

TRAIN_STAGES = {k: v for k, v in HTSAT_STAGES.items() if k != "stage4"}   # K8 runs in stages 1-3


@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("stage", sorted(TRAIN_STAGES))
def test_k8_bf16_stages_take_the_tensor_cores(stage, B):
    H, C, _ = TRAIN_STAGES[stage]
    plan = wa.mlp_bwd_plan(torch.bfloat16, B * H * H, C, 4 * C)
    assert plan[0] == "tc"
    # 8 warps a block: (rows / 16) row tiles x (C / 96) column groups
    assert (plan[1] // 16) * (C // 96) == 8
    # both weight products of such a launch take the tensor cores too
    assert wa.wgrad_plan(torch.bfloat16, B * H * H, C, 4 * C)[0] == "tc"
    assert wa.wgrad_plan(torch.bfloat16, B * H * H, 4 * C, C)[0] == "tc"


@pytest.mark.parametrize("stage", sorted(HTSAT_STAGES))
def test_train_backward_in_fp32_keeps_the_fma_kernels(stage):
    H, C, _ = HTSAT_STAGES[stage]
    n_tok = 64 * H * H
    assert wa.mlp_bwd_plan(torch.float32, n_tok, C, 4 * C) == ("fma",)
    for M, Ncol in ((C, 4 * C), (4 * C, C), (C, 3 * C), (C, C)):
        assert wa.wgrad_plan(torch.float32, n_tok, M, Ncol)[0] == "fma"


@pytest.mark.parametrize("C,hidden", [(32, 128), (16, 64), (768, 3072), (288, 1152), (96, 200),
                                      (96, 768), (128, 512)],
                         ids=["C32", "C16", "C768", "C288", "hidden200", "hidden8C", "C128"])
def test_other_bf16_widths_of_k8_take_the_fma_kernel(C, hidden):
    assert wa.mlp_bwd_plan(torch.bfloat16, 4096, C, hidden) == ("fma",)


@pytest.mark.parametrize("stage", sorted(HTSAT_STAGES))
def test_every_weight_gradient_of_the_stages_takes_the_tensor_cores(stage):
    """dWqkv and dWproj of K9 (K6 at stage 4), dWfc1 and dWfc2 of K8, with the
    chunk rule: about ``_WGRAD_BLOCKS`` blocks, at least 256 tokens a chunk."""
    H, C, _ = HTSAT_STAGES[stage]
    n_tok = 64 * H * H
    for M, Ncol in ((C, 3 * C), (C, C), (C, 4 * C), (4 * C, C)):
        kind, n_chunks = wa.wgrad_plan(torch.bfloat16, n_tok, M, Ncol)
        tiles = (M // 96) * (Ncol // 96)
        assert kind == "tc"
        assert 1 <= n_chunks <= n_tok // 256
        assert n_chunks * tiles >= min(wa._WGRAD_BLOCKS, tiles * (n_tok // 256))
        assert (n_chunks - 1) * tiles < wa._WGRAD_BLOCKS


@pytest.mark.parametrize("M,Ncol,has_a", [(32, 128, True), (96, 100, True), (100, 96, True),
                                          (64, 64, True), (1, 96, False), (1, 384, False),
                                          (1, 96, True)],
                         ids=["C32", "Ncol100", "M100", "64x64", "colsum96", "colsum384",
                              "one-column-A"])
def test_other_bf16_weight_gradients_and_column_sums_take_the_fma_kernel(M, Ncol, has_a):
    kind, n_chunks = wa.wgrad_plan(torch.bfloat16, 8192, M, Ncol, has_a)
    assert kind == "fma" and 1 <= n_chunks <= 32


def test_few_tokens_make_one_chunk():
    assert wa.wgrad_plan(torch.bfloat16, 64, 96, 96) == ("tc", 1)
    assert wa.wgrad_plan(torch.float32, 64, 96, 96) == ("fma", 1)


@pytest.mark.parametrize("call,error,match", [
    (lambda: wa.mlp_bwd_plan(torch.float16, 4096, 96, 384), TypeError, "dtype"),
    (lambda: wa.mlp_bwd_plan(torch.bfloat16, 4100, 96, 384), ValueError, "multiple of 8"),
    (lambda: wa.mlp_bwd_plan(torch.bfloat16, 0, 96, 384), ValueError, "multiple of 8"),
    (lambda: wa.mlp_bwd_plan(torch.float32, 4096, 96, 0), ValueError, "hidden 0"),
    (lambda: wa.wgrad_plan(torch.float16, 4096, 96, 96), TypeError, "dtype"),
    (lambda: wa.wgrad_plan(torch.bfloat16, 0, 96, 96), ValueError, "no product"),
    (lambda: wa.wgrad_plan(torch.bfloat16, 4096, 0, 96), ValueError, "no product"),
    (lambda: wa.wgrad_plan(torch.bfloat16, 4096, 96, 96, False), ValueError, "no product"),
], ids=["k8-fp16", "k8-ragged", "k8-empty", "k8-hidden0", "wgrad-fp16", "wgrad-empty",
        "wgrad-M0", "colsum-M96"])
def test_train_plans_refuse_what_neither_kernel_takes(call, error, match):
    with pytest.raises(error, match=match):
        call()


def test_cpu_route_of_the_train_backward_raises_no_count():
    """On CPU tensors K8, K9 and K6 take the plain versions: no launch count,
    no tensor-core count and no weight-product count moves."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32)).bfloat16()
    C, heads = 96, 4
    x, g = f(2, 8, 8, C), f(2, 8, 8, C)
    w = [f(C) + 1, f(C), f(C, 3 * C), f(3 * C), f(C, C), f(C), f(C) + 1, f(C),
         f(C, 4 * C), f(4 * C), f(4 * C, C), f(C)]
    bias = torch.zeros(1, 1, heads, 64, 64)
    keep = torch.tensor([1.0, 0.0])
    counts = lambda: (wa.mlp_bwd.launches, wa.mlp_bwd.tc_launches, wa.attn_ln1_bwd.launches,
                      wa.attn_ln1_bwd.tc_launches, wa.window_attention_bwd.launches,
                      wa.window_attention_bwd.tc_launches, wa._wgrad.tc_launches)
    before = counts()
    k8 = wa.mlp_bwd(x, g, keep, *w[6:11], 1e-6)
    k9 = wa.attn_ln1_bwd(x, k8[0], keep, *w[:5], bias, 8, heads, 0, 1e-6)
    k6 = wa.window_attention_bwd(x, g, *w[2:6], bias, 8, heads, 0)
    assert counts() == before
    assert k8[0].shape == k9[0].shape == k6[0].shape == x.shape
    assert k8[3].shape == (C, 4 * C) and k8[5].shape == (4 * C, C)
    # the dropped sample passes its cotangent through
    assert torch.equal(k8[0][1], g[1])
    # and through autograd: the train block on the CPU raises none either
    leaves = [t.float().requires_grad_() for t in [x] + w]
    out = wa.fused_swin_block_train(*leaves, bias, keep, keep, 8, heads, 0, 1e-6)
    out.sum().backward()
    assert counts() == before and leaves[9].grad.shape == (C, 4 * C)


# -- the train backward: the per-token kernels of K9 and K6 ------------------------


@pytest.mark.parametrize("stage", sorted(TRAIN_STAGES))
def test_k9_bf16_stages_take_the_tensor_cores(stage):
    """K9 (LN1 + attention backward) in bf16 at stages 1-3: kernel A per
    window and kernel B (dx) on the tensor cores, B's blocks 8 warps of 16
    rows x 96 columns; both weight products of the launch take the tensor
    cores too."""
    H, C, heads = TRAIN_STAGES[stage]
    plan = wa.attn_bwd_plan(torch.bfloat16, 64, C, C // heads, True)
    assert plan[0] == "tc"
    assert (plan[1] // 16) * (C // 96) == 8
    for M, Ncol in ((C, 3 * C), (C, C)):
        assert wa.wgrad_plan(torch.bfloat16, 64 * H * H, M, Ncol)[0] == "tc"


@pytest.mark.parametrize("B", [1, 3, 64])
def test_k6_bf16_stage4_takes_the_tensor_cores(B):
    """K6 (the window-attention backward, no LN1, no m1) in bf16 at stage 4,
    its one main-path shape: kernels A and B on the tensor cores, B's blocks 8
    warps of 16 rows x 96 columns (16 rows at C = 768); both weight products
    of the launch take the tensor cores too."""
    plan = wa.attn_bwd_plan(torch.bfloat16, 64, 768, 24, False)
    assert plan == ("tc", 16)
    assert (plan[1] // 16) * (768 // 96) == 8
    for M, Ncol in ((768, 3 * 768), (768, 768)):
        assert wa.wgrad_plan(torch.bfloat16, B * 64, M, Ncol)[0] == "tc"


@pytest.mark.parametrize("dtype,N,C,d,ln", [
    (torch.float32, 64, 96, 24, True),       # fp32: TF32 would break the fixtures
    (torch.float32, 64, 384, 24, True),
    (torch.float32, 64, 768, 24, False),     # K6 in fp32 at stage 4
    (torch.bfloat16, 64, 96, 24, False),     # K6 at a stage-1 shape
    (torch.bfloat16, 64, 384, 24, False),    # K6 at a stage-3 shape
    (torch.bfloat16, 64, 768, 24, True),     # C = 768: no stage K9 runs at
    (torch.bfloat16, 64, 128, 32, True),     # d = 32
    (torch.bfloat16, 64, 96, 16, True),      # d = 16
    (torch.bfloat16, 16, 32, 8, True),       # 4x4 windows (the fixtures' tiny HTSAT)
    (torch.bfloat16, 32, 96, 24, True),      # N = 32
    (torch.bfloat16, 64, 288, 24, True),     # C = 3 x 96
], ids=["fp32-C96", "fp32-C384", "k6-fp32-C768", "k6-C96", "k6-C384", "C768", "d32", "d16",
        "4x4", "N32", "C288"])
def test_other_k9_and_k6_shapes_take_the_fma_kernels(dtype, N, C, d, ln):
    assert wa.attn_bwd_plan(dtype, N, C, d, ln) == ("fma",)


@pytest.mark.parametrize("dtype,N,C,d,error,match", [
    (torch.float16, 64, 96, 24, TypeError, "dtype"),
    (torch.bfloat16, 64, 192, 96, ValueError, "head dim"),
    (torch.float32, 64, 60, 12, ValueError, "multiple of 8"),
    (torch.bfloat16, 36, 96, 24, ValueError, "tokens per window"),
    (torch.bfloat16, 256, 96, 24, ValueError, "tokens per window"),
], ids=["fp16", "d96", "d12", "6x6", "16x16"])
def test_attn_bwd_plan_refuses_what_neither_kernel_takes(dtype, N, C, d, error, match):
    for ln in (True, False):
        with pytest.raises(error, match=match):
            wa.attn_bwd_plan(dtype, N, C, d, ln)
