"""The cost functions reproduce the bounds the port's kernel table prints
(PERF.md section 6: K1 at B=256 x 12 heads bf16, the rest at B=64 bf16)."""

import statistics

import pytest

from benchmark import harness

AUDIO = dict(sr=32000, n_fft=1024, hop_length=320, n_mels=64, f_min=50, f_max=14000)
STAGES = [(64, 96, 4), (32, 192, 8), (16, 384, 16)]


def us(seconds):
    return round(seconds * 1e6, 1)


def test_k1_bound_mean_over_the_decode_indices():
    k1 = harness.load_module("costs", "k1")
    calls = [k1.bound(256, 12, 64, index, 2) for index in range(10, 77)]
    assert us(statistics.mean(c[0] for c in calls)) == 6.0
    assert round(statistics.mean(c[1] for c in calls) / 1e6, 2) == 19.96


def test_k2_bound_and_filterbank_nonzeros():
    k2 = harness.load_module("costs", "k2")
    assert us(k2.bound(64, 320000, AUDIO)) == 29.3
    assert 0 < k2.mel_nonzeros(32000, 1024, 64, 50, 14000) < 513 * 64


@pytest.mark.parametrize("stage,k3,k9", [(0, 65.1, 73.3), (1, 61.9, 63.5), (2, 60.3, 58.6)])
def test_window_and_train_bounds_per_stage(stage, k3, k9):
    window = harness.load_module("costs", "window")
    train = harness.load_module("costs", "swin_train")
    H, C, heads = STAGES[stage]
    assert us(window.bound(64, H, C, heads, 8, 2, True)) == k3
    assert us(train.bound("K7", 64, H, C, heads, 2)) == k3
    assert us(train.bound("K8", 64, H, C, heads, 2)) == 97.7
    assert us(train.bound("K9", 64, H, C, heads, 2)) == k9


def test_stage4_bounds():
    window = harness.load_module("costs", "window")
    train = harness.load_module("costs", "swin_train")
    assert us(window.bound(64, 8, 768, 32, 8, 2, False)) == 20.4
    assert us(train.bound("K6", 64, 8, 768, 32, 2)) == 56.2


def test_int8_gemm_bound_is_the_larger_of_ops_and_bytes():
    g = harness.load_module("costs", "int8_gemm")
    # M = 1: bytes (the weight) bound it; M = 8192 square: operations
    assert g.bound(1, 4096, 4096) == pytest.approx((4096 + 4096 * 4096 + 4 * 4096) / 3.35e12)
    assert g.bound(8192, 8192, 8192) == pytest.approx(2 * 8192 ** 3 / 1979e12)


def test_caption_batch_ops_count_every_gemm_once():
    cost = harness.load_module("costs", "gpt2_caption")
    cfg = harness.load_json("configs", "htsat-gpt2.json")
    B, N = 1024, 67
    gemms = cost.int8_gemms(cfg, B, N)
    # 12 layers x 4 products + the logits, for the prefill and each of the N steps
    assert sum(c for *_, c in gemms) == (12 * 4 + 1) * (N + 1)
    per_token = 2 * (12 * 12 * 768 ** 2 + 768 * 50257)
    assert cost.batch_ops(cfg, B, N) == pytest.approx(per_token * B * (10 + N), rel=0.05)
    mcost = harness.load_module("costs", "mistral_caption")
    mcfg = harness.load_json("configs", "mistral7b-lora.json")
    fused = mcost.int8_gemms(mcfg, 256, 60, True)
    assert sum(c for *_, c in fused) == (32 * 4 + 1) * 60
    per_token = 2 * 7.24e9
    assert mcost.batch_ops(mcfg, 256, 60) == pytest.approx(per_token * 256 * 72, rel=0.05)
