"""The w8a8 GEMM's quantize and rescale kernels (``csrc/quant.cu``) against
their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA card is present
(a CUDA kernel has no CPU build). The file imports neither JAX nor the JAX
package; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_quant_cuda.py

Every comparison is bitwise: the kernels do the plain versions' IEEE
operations in the same order, and the abs-max is exact in any order. The
q8 decodes (GPT-2 with K1, Mistral over the int8 cache with LoRA) give the
same tokens and the same logits through the kernels as through the plain
versions, and launch one quantize and one rescale per int8 GEMM.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zs_aac_tpu_torch.models import gpt2 as tg
from zs_aac_tpu_torch.models import mistral as tm
from zs_aac_tpu_torch.ops import quant as Q


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the quantize and rescale kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rows(M, K, dtype, seed):
    """Random rows (N(0, 3)) whose first rows are the edge cases: exact .5
    ties after scaling (the row's abs-max 127 * 2^-3 makes the scale 2^-3,
    and every value is (k + 1/2) * 2^-3), all zeros (the 1e-8 clamp), and
    a row whose largest magnitude is a negative value."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda") * 3
    k = torch.randint(-126, 126, (K,), generator=g, device="cuda").float() + 0.5
    x[0] = k * 0.125
    x[0, K // 2] = 127 * 0.125
    if M > 1:
        x[1] = 0
    if M > 2:
        x[2] = x[2].abs() * 0.5
        x[2, K - 1] = -x[2].max() * 1.5
    return x.to(dtype)


DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("K", [24, 768, 1000, 3072, 4096, 14336])
@pytest.mark.parametrize("M", [1, 7, 8192])
def test_quant_act_kernel_is_bitwise_the_plain_version(M, K, dtype):
    _need_cuda()
    x = _rows(M, K, dtype, seed=M + K)
    before = Q.quant_act.launches
    with torch.no_grad():
        q, s = Q.quant_act(x)
    q0, s0 = Q.quant_act_plain(x)
    torch.cuda.synchronize()
    assert Q.quant_act.launches == before + 1
    assert q.shape == (M, K) and s.shape == (M, 1)
    assert torch.equal(q, q0) and torch.equal(s, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_quant_act_kernel_takes_strided_misaligned_and_batched_rows(dtype):
    """Rows a stride apart (16-byte loads), rows off 16 bytes and an odd K
    (single-element loads), and a [B, L, K] input."""
    _need_cuda()
    base = _rows(64, 800, dtype, seed=5)
    flat = base.reshape(-1)
    cases = [base[:, :768], flat[1:1 + 63 * 768].view(63, 768), base[:, :777],
             _rows(6 * 5, 768, dtype, seed=6).view(6, 5, 768)]
    for x in cases:
        with torch.no_grad():
            q, s = Q.quant_act(x)
        q0, s0 = Q.quant_act_plain(x)
        assert torch.equal(q, q0) and torch.equal(s, s0), tuple(x.shape)
        assert s.shape == (*x.shape[:-1], 1)


def _rescale_inputs(M, N, out_dtype, bias, seed, K=14336):
    """int32 results of a K-deep int8 GEMM, up to +-K * 127^2 (both ends
    present), per-row and per-column scales as the model's, a bias in the
    output dtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lim = K * 127 * 127
    y = torch.randint(-lim, lim + 1, (M, N), generator=g, device="cuda", dtype=torch.int32)
    y[0, 0], y[-1, -1] = lim, -lim
    sx = torch.rand(M, 1, generator=g, device="cuda") * 0.05 + 1e-4
    ws = torch.rand(N, generator=g, device="cuda") * 0.01 + 1e-5
    b = torch.randn(N, generator=g, device="cuda").to(out_dtype) if bias else None
    return y, sx, ws, b


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("out_dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N", [8, 768, 6144, 50264, 50257, 6])
@pytest.mark.parametrize("M", [1, 7, 8192])
def test_int8_rescale_kernel_is_bitwise_the_plain_version(M, N, out_dtype, bias):
    _need_cuda()
    y, sx, ws, b = _rescale_inputs(M, N, out_dtype, bias, seed=M + N)
    before = Q.int8_rescale.launches
    with torch.no_grad():
        out = Q.int8_rescale(y, sx, ws, out_dtype, b)
    ref = Q.int8_rescale_plain(y, sx, ws, out_dtype, b)
    torch.cuda.synchronize()
    assert Q.int8_rescale.launches == before + 1
    assert out.dtype == out_dtype and torch.equal(out, ref)


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    x = _rows(4, 64, torch.float32, seed=1)
    with pytest.raises(TypeError):
        Q.quant_act(x.half())
    with pytest.raises(ValueError):
        Q.quant_act(torch.zeros(2, 9001, device="cuda"))   # 9,001 single-element loads a row
    with pytest.raises(RuntimeError):
        Q.quant_act(x.clone().requires_grad_(True))
    y, sx, ws, b = _rescale_inputs(4, 64, torch.bfloat16, True, seed=2)
    with pytest.raises(TypeError):
        Q.int8_rescale(y.float(), sx, ws, torch.bfloat16, b)
    with pytest.raises(TypeError):
        Q.int8_rescale(y, sx, ws, torch.float16)
    with pytest.raises(TypeError):
        Q.int8_rescale(y, sx, ws, torch.bfloat16, b.float())
    with pytest.raises(ValueError):
        Q.int8_rescale(y, sx[:2], ws, torch.bfloat16, b)
    with pytest.raises(ValueError):
        Q.int8_rescale(y, sx, ws[:32], torch.bfloat16)
    with pytest.raises(ValueError):
        Q.int8_rescale(y.t(), sx[:1].expand(64, 1).contiguous(), ws[:4], torch.bfloat16)
    with pytest.raises(RuntimeError):
        Q.int8_rescale(y, sx, ws.clone().requires_grad_(True), torch.bfloat16)
    with torch.no_grad():
        Q.int8_rescale(y, sx, ws.clone().requires_grad_(True), torch.bfloat16)


@pytest.fixture
def plain_int8_dot(monkeypatch):
    """Sends every int8 GEMM's quantize and rescale through the plain
    versions (``_int8_dot`` reads both from the GPT-2 module; Mistral and
    the int8 BERT tower call that ``_int8_dot``)."""
    def use_plain():
        monkeypatch.setattr(tg, "quant_act", Q.quant_act_plain)
        monkeypatch.setattr(tg, "int8_rescale", Q.int8_rescale_plain)
    return use_plain


GCFG = tg.GPT2Config(vocab_size=101, n_positions=64, n_embd=128, n_layer=2, n_head=4)


def _gpt2_run(params, emb, tokens):
    """Prefill and 10 steps over the int8 cache (K1): logits of each, then a
    greedy decode's tokens and lengths."""
    B, Lp, _ = emb.shape
    out = []
    with torch.no_grad():
        cache = tg.init_kv_cache_q8(GCFG, B, Lp + tokens.shape[1], device="cuda")
        logits, _ = tg.gpt2_prefill_q8(params, GCFG, emb, cache)
        out.append(logits)
        for i in range(tokens.shape[1]):
            lg, _ = tg.gpt2_step_q8(params, GCFG, tg.gpt2_embed(params, tokens[:, i]), cache,
                                    Lp + i)
            out.append(lg)
    from zs_aac_tpu_torch.decoding.greedy import greedy_decode_q8
    return out, greedy_decode_q8(params, GCFG, emb, 12, -1, -1)


@pytest.mark.cuda
def test_gpt2_q8_decode_through_the_kernels_is_bitwise_the_plain_path(plain_int8_dot):
    """fp32 GPT-2 w8a8 + int8 cache (K1 in both): the same logits at every
    step and the same greedy tokens; one quantize and one rescale per int8
    GEMM, 4 a layer and the LM head's (4 L + 1 a step)."""
    _need_cuda()
    params = tg.quantize_gpt2_int8(tg.init_gpt2(GCFG, seed=0, device="cuda"), "w8a8")
    g = torch.Generator(device="cuda").manual_seed(1)
    emb = torch.randn(20, 6, GCFG.n_embd, generator=g, device="cuda")
    tokens = torch.randint(0, GCFG.vocab_size, (20, 10), generator=g, device="cuda")
    x = tg.gpt2_embed(params, tokens[:, 0])
    cache = tg.init_kv_cache_q8(GCFG, 20, 16, device="cuda")
    with torch.no_grad():
        tg.gpt2_prefill_q8(params, GCFG, emb, cache)
        q0, r0 = Q.quant_act.launches, Q.int8_rescale.launches
        tg.gpt2_step_q8(params, GCFG, x, cache, 6)
    per_step = 4 * GCFG.n_layer + 1
    assert (Q.quant_act.launches - q0, Q.int8_rescale.launches - r0) == (per_step, per_step)
    kernel_logits, (kt, kl) = _gpt2_run(params, emb, tokens)
    plain_int8_dot()
    q0 = Q.quant_act.launches
    plain_logits, (pt, pl) = _gpt2_run(params, emb, tokens)
    assert Q.quant_act.launches == q0
    for a, b in zip(kernel_logits, plain_logits):
        assert torch.equal(a, b)
    assert torch.equal(kt, pt) and torch.equal(kl, pl)


MCFG = tm.MistralConfig(vocab_size=1003, hidden_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
                        intermediate_size=688, sliding_window=16, max_positions=64)


def _mistral_run(params, lora, emb, tokens):
    from zs_aac_tpu_torch.decoding.greedy import _cast_matrices, mistral_greedy_decode

    B, Lp, _ = emb.shape
    lora16 = _cast_matrices(lora, emb.dtype)
    out = []
    with torch.no_grad():
        cache = tm.init_mistral_cache_q8(MCFG, B, Lp + tokens.shape[1])
        logits, _ = tm.mistral_prefill(params, MCFG, emb, cache, lora=lora16)
        out.append(logits)
        for i in range(tokens.shape[1]):
            lg, _ = tm.mistral_step(params, MCFG, tm.mistral_embed(params, tokens[:, i]), cache,
                                    Lp + i, lora=lora16)
            out.append(lg)
    return out, mistral_greedy_decode(params, MCFG, emb, lora, 12, -1, q8_cache=True)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_mistral_q8_decode_through_the_kernels_is_bitwise_the_plain_path(fuse, plain_int8_dot):
    """bf16 Mistral w8a8 (unfused and the fused wqkv/gateup widths) over the
    int8 cache with LoRA, past the sliding window: the same logits at every
    step and the same greedy tokens; 7 int8 GEMMs a layer unfused, 4 fused
    (wqkv, wo, gateup, down), and the LM head's (1003 columns padded to
    1008)."""
    _need_cuda()
    base = tm.init_mistral(MCFG, seed=2, device="cuda")
    params = tm.quantize_mistral_int8(base, "w8a8", fuse=fuse)
    lora = tm.init_lora(MCFG, r=4, alpha=8, seed=3, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    lora = {**lora, "layers": [{n: {"a": p["a"], "b": torch.randn(
        p["b"].shape, generator=g, device="cuda") * 0.05} for n, p in lp.items()}
        for lp in lora["layers"]]}
    emb = torch.randn(9, 5, MCFG.hidden_size, generator=g, device="cuda").to(torch.bfloat16)
    tokens = torch.randint(0, MCFG.vocab_size, (9, 20), generator=g, device="cuda")
    q0, r0 = Q.quant_act.launches, Q.int8_rescale.launches
    kernel_logits, (kt, kl) = _mistral_run(params, lora, emb, tokens[:, :1])
    per_step = (4 if fuse else 7) * MCFG.n_layers + 1
    # the prefill and one step in _mistral_run; then the decode's prefill and 11 steps
    assert Q.quant_act.launches - q0 == Q.int8_rescale.launches - r0 == 14 * per_step
    kernel_logits, (kt, kl) = _mistral_run(params, lora, emb, tokens)
    plain_int8_dot()
    plain_logits, (pt, pl) = _mistral_run(params, lora, emb, tokens)
    for a, b in zip(kernel_logits, plain_logits):
        assert torch.equal(a, b)
    assert torch.equal(kt, pt) and torch.equal(kl, pl)


@pytest.mark.cuda
def test_the_kernels_link_to_their_launches_inside_layer_quant_and_layer_rescale():
    """Under torch.profiler every quantize and rescale kernel of a w8a8
    GPT-2 decode links to its launch record (``quant_act``,
    ``int8_rescale``), which lies inside a ``layer.quant`` or
    ``layer.rescale`` span, as K1's launch lies inside ``layer.attn``."""
    _need_cuda()
    from zs_aac_tpu_torch.decoding.greedy import greedy_decode_q8

    params = tg.quantize_gpt2_int8(tg.init_gpt2(GCFG, seed=1, device="cuda"), "w8a8")
    emb = torch.randn(4, 3, GCFG.n_embd, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    steps = 5
    greedy_decode_q8(params, GCFG, emb, steps, -1, -1)          # builds and warms the kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        greedy_decode_q8(params, GCFG, emb, steps, -1, -1)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.profiler.kineto_results.events())
    host = {e.correlation_id(): e for e in events
            if e.device_type() == cpu and e.linked_correlation_id() == 0
            and not e.name().startswith("cu")}
    spans = {name: [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.name() == name and e.device_type() == cpu]
             for name in ("layer.quant", "layer.rescale")}
    # the prefill and `steps` cached steps, 4 L + 1 int8 GEMMs each
    dots = (steps + 1) * (4 * GCFG.n_layer + 1)
    for kernel, launch, span in (("quant_act_kernel", "quant_act", "layer.quant"),
                                 ("int8_rescale_kernel", "int8_rescale", "layer.rescale")):
        found = [e for e in events if e.device_type() != cpu and kernel in e.name()]
        assert len(found) == dots, (kernel, len(found))
        for e in found:
            op = host.get(e.linked_correlation_id())
            assert op is not None and op.name() == launch
            assert any(s <= op.start_ns() and op.start_ns() + op.duration_ns() <= t
                       for s, t in spans[span])
