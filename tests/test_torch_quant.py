"""The w8a8 GEMM's quantize and rescale (``ops/quant.py``) on the CPU.

- ``quant_plan`` and ``rescale_plan``, the rule that picks each shape's
  instantiation of ``csrc/quant.cu``: the caption cells' shapes, the fused
  Mistral widths, odd widths, misaligned rows, and that every plan is a
  valid launch that covers each row and column once (M = 1-16 too).
- CPU tensors take the plain versions, which are today's expressions bit
  for bit, and launch nothing.
- The CUDA wrappers' argument checks, run on CPU tensors' metadata.

The kernels themselves are held to the plain versions on a card
(``tests/test_torch_quant_cuda.py``).
"""

import pytest
import torch

from zs_aac_tpu_torch.ops import quant as Q

F32, BF16 = torch.float32, torch.bfloat16


# (K, dtype) -> (vec, threads a row, rows a block)
@pytest.mark.parametrize("K,dtype,plan", [
    (768, F32, (4, 32, 8)),        # GPT-2: c_attn, attn.c_proj, c_fc, the head
    (3072, F32, (4, 128, 2)),      # GPT-2: GELU -> mlp.c_proj
    (768, BF16, (8, 32, 8)),       # bf16 GPT-2, the int8 BERT tower
    (3072, BF16, (8, 64, 4)),
    (4096, BF16, (8, 64, 4)),      # Mistral-7B: q/k/v/gate/up (fused or not), wo, lm_head
    (14336, BF16, (8, 256, 1)),    # Mistral-7B: SwiGLU -> down
])
def test_quant_plan_at_the_served_shapes(K, dtype, plan):
    assert Q.quant_plan(K, dtype) == plan


def _check_quant_plan(K, dtype, align):
    vec, tpr, rows = Q.quant_plan(K, dtype, align)
    assert K % vec == 0 and vec in (1, 16 // dtype.itemsize)
    assert vec == 1 or align % 16 == 0
    assert tpr % 32 == 0 and 32 <= tpr <= 1024 and tpr & (tpr - 1) == 0
    assert tpr * 8 >= K // vec                    # every load of a row has a thread
    assert tpr == 32 or tpr * 4 < K // vec        # and no fewer threads would do
    assert rows >= 1 and tpr * rows <= 1024
    for M in range(1, 17):                             # whole blocks over M rows
        blocks = -(-M // rows)
        assert (blocks - 1) * rows < M <= blocks * rows


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("K", [1, 3, 7, 8, 24, 100, 768, 777, 1000, 1001, 2049, 3072, 4096,
                               8191, 8192, 14336, 28672])
def test_quant_plan_is_a_launch_that_covers_each_row(K, dtype):
    for align in (16, 4):
        if K > 8192 and (align < 16 or K % (16 // dtype.itemsize)):
            with pytest.raises(ValueError):        # 8,192 single-element loads at most
                Q.quant_plan(K, dtype, align)
        else:
            _check_quant_plan(K, dtype, align)


def test_quant_plan_takes_single_elements_off_16_bytes_and_refuses_what_it_cannot_hold():
    assert Q.quant_plan(768, F32, 4)[0] == 1 and Q.quant_plan(768, BF16, 8)[0] == 1
    assert Q.quant_plan(1001, F32)[0] == 1 and Q.quant_plan(1004, BF16)[0] == 1
    assert Q.quant_plan(32768, F32) == (4, 1024, 1)
    assert Q.quant_plan(65536, BF16) == (8, 1024, 1)
    for K, dtype, align in ((8193, F32, 16), (14336, BF16, 2), (65544, BF16, 16)):
        with pytest.raises(ValueError):
            Q.quant_plan(K, dtype, align)
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            Q.quant_plan(768, dtype)
    with pytest.raises(ValueError):
        Q.quant_plan(0, F32)


# N -> (vec, threads): the columns of every int8 GEMM in the caption cells
@pytest.mark.parametrize("N,plan", [
    (2304, (4, 192)),     # GPT-2 c_attn: three tiles of 192 threads
    (768, (4, 192)),      # GPT-2 attn.c_proj, mlp.c_proj; BERT's q/k/v/o
    (3072, (4, 256)),     # GPT-2 mlp.c_fc
    (50264, (4, 256)),    # GPT-2's int8 wte, padded from 50,257
    (4096, (4, 256)),     # Mistral wq, wo, down
    (1024, (4, 256)),     # Mistral wk, wv
    (14336, (4, 256)),    # Mistral gate, up
    (32000, (4, 256)),    # Mistral lm_head
    (6144, (4, 256)),     # Mistral fused wqkv
    (28672, (4, 256)),    # Mistral fused gateup
])
def test_rescale_plan_at_the_served_shapes(N, plan):
    for dtype in (F32, BF16):
        assert Q.rescale_plan(N, dtype) == plan


@pytest.mark.parametrize("N", [1, 2, 3, 6, 8, 13, 100, 768, 2304, 4097, 50257, 50264, 100003])
def test_rescale_plan_is_a_launch_that_covers_each_column(N):
    for align in (16, 8, 4):
        vec, threads = Q.rescale_plan(N, BF16, align)
        assert N % vec == 0 and 4 * vec <= align and vec in (1, 2, 4)
        assert vec == 4 or N % (2 * vec) or 8 * vec > align   # the widest that fits
        assert threads % 32 == 0 and 32 <= threads <= 256
        tiles = -(-(N // vec) // threads)
        assert tiles * threads * vec >= N > (tiles - 1) * threads * vec
        assert tiles == -(-(N // vec) // 256) and (threads - 32) * tiles < N // vec


def test_rescale_plan_refuses_other_dtypes_and_empty_rows():
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            Q.rescale_plan(768, dtype)
    with pytest.raises(ValueError):
        Q.rescale_plan(0, F32)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_cpu_tensors_take_the_plain_quantize(dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, 768, generator=g) * 4).to(dtype)
    x[0, 0] = 0
    before = Q.quant_act.launches
    xq, sx = Q.quant_act(x)
    want_s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True).float()
                             / torch.tensor(127.0), 1e-8)
    want_q = torch.clamp(torch.round(x.float() / want_s), -127, 127).to(torch.int8)
    assert torch.equal(sx, want_s) and torch.equal(xq, want_q)
    assert xq.dtype == torch.int8 and sx.shape == (3, 5, 1)
    assert bool((xq[0, 0] == 0).all()) and float(sx[0, 0]) == pytest.approx(1e-8)
    assert Q.quant_act.launches == before


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_cpu_tensors_take_the_plain_rescale(dtype, bias):
    g = torch.Generator().manual_seed(1)
    lim = 3072 * 127 * 127
    y = torch.randint(-lim, lim + 1, (2, 3, 50264), generator=g, dtype=torch.int32)
    sx = torch.rand(2, 3, 1, generator=g) * 0.05 + 1e-4
    ws = torch.rand(50264, generator=g) * 0.01 + 1e-5
    b = torch.randn(50264, generator=g).to(dtype) if bias else None
    before = Q.int8_rescale.launches
    out = Q.int8_rescale(y, sx, ws, dtype, b)
    want = (y.float() * sx * ws).to(dtype)
    want = want if b is None else want + b
    assert out.dtype == dtype and torch.equal(out, want)
    assert Q.int8_rescale.launches == before


def test_the_quantize_wrapper_checks_its_input():
    x = torch.randn(4, 6, 800)
    rows, plan = Q._quant_args(x[..., :768])          # rows 800 apart: copied, contiguous
    assert rows.shape == (24, 768) and rows.is_contiguous() and plan[0] == 4
    rows, plan = Q._quant_args(x.transpose(1, 2))     # a last stride other than 1 is copied
    assert rows.is_contiguous() and rows.shape == (4 * 800, 6)
    off = x.reshape(-1)[1:1 + 768 * 3].view(3, 768)   # 4 bytes off 16: single elements
    assert Q._quant_args(off)[1][0] == 1
    with pytest.raises(TypeError):
        Q._quant_args(x.double())
    with pytest.raises(ValueError):
        Q._quant_args(torch.tensor(1.0))
    with pytest.raises(RuntimeError):
        Q._quant_args(x.requires_grad_(True))
    with torch.no_grad():
        Q._quant_args(x)


def test_the_rescale_wrapper_checks_its_inputs():
    y = torch.zeros(2, 3, 64, dtype=torch.int32)
    sx, ws, b = torch.ones(2, 3, 1), torch.ones(64), torch.zeros(64, dtype=BF16)
    assert Q._rescale_args(y, sx, ws, BF16, b) == (6, 64, (4, 32))
    for args, err in [((y.float(), sx, ws, BF16, b), TypeError),
                      ((y, sx.double(), ws, BF16, b), TypeError),
                      ((y, sx, ws, torch.float16, None), TypeError),
                      ((y, sx, ws, BF16, b.float()), TypeError),
                      ((y, sx[:1], ws, BF16, b), ValueError),
                      ((y, sx[..., 0], ws, BF16, b), ValueError),
                      ((y, sx, ws[:32], BF16, b), ValueError),
                      ((y, sx, ws, BF16, b[:32]), ValueError),
                      ((y.transpose(0, 1), sx.transpose(0, 1), ws, BF16, None), ValueError),
                      ((y, sx, torch.ones(128)[::2], BF16, None), ValueError),
                      ((y, sx, ws.clone().requires_grad_(True), BF16, b), RuntimeError),
                      ((y, sx, ws, BF16, b.clone().requires_grad_(True)), RuntimeError)]:
        with pytest.raises(err):
            Q._rescale_args(*args)
