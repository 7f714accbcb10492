"""The Mistral port's int8 GEMMs on a card (``torch._int_mm``).

Marked ``cuda``: skips where no CUDA card is present (``torch._int_mm`` on
CUDA wants N % 8 == 0 and more than 16 rows, the constraints this holds;
the CPU takes other paths). Imports neither JAX nor the JAX package; on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_mistral_cuda.py

The w8a8 lm_head at a vocabulary that is not a multiple of 8 (padded with
zero columns of scale 1, logits cut back) at M < 17 rows equals its
dequantized float product: the same int8 values summed exactly in int32
and in float64, rescaled by the same fp32 operations; tolerance 1e-5 of
the largest logit.
"""

import pytest
import torch

from zs_aac_tpu_torch.models import mistral as tm
from zs_aac_tpu_torch.ops.quant import quant_act


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's CUDA constraints")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 16, 17])
@pytest.mark.parametrize("vocab", [534, 32001])
def test_w8a8_lm_head_matches_dequantized_product(vocab, rows, dtype):
    _need_cuda()
    cfg = tm.MistralConfig(vocab_size=vocab, hidden_size=64, n_layers=1, n_heads=4, n_kv_heads=2,
                           intermediate_size=128)
    params = tm.init_mistral(cfg, 0, "cuda", dtype)
    q = tm.quantize_mistral_int8(params, "w8a8")
    head = q["lm_head"]
    assert head["w"].shape[1] % 8 == 0 and head["w"].shape[1] >= vocab
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(rows, 1, 64, generator=g, device="cuda").to(dtype)
    got = tm._head(q, cfg, x, None, None)[:, 0]
    assert got.shape == (rows, vocab) and got.dtype == dtype
    xn = tm._rms_norm(x, q["norm"], cfg.rms_norm_eps)[:, 0]
    xq, sx = quant_act(xn)
    acc = xq.double() @ head["w"][:, :vocab].double()
    want = ((acc.float() * sx) * head["scale_a8"][:vocab]).to(dtype)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-5 * want.float().abs().max().item(), err
