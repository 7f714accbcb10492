"""Tiny sizes for the CPU tests of configurations that ``tests/tiny.py``
does not list, and the greedy decode that ``tests/test_bench_faults.py``
breaks for each, registered once the tests are collected."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TINY_CONFIGS = {
    "deepseek-v2-lite": dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                             num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
                             n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=32,
                             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                             vocab_size=512,
                             mapper={"type": "mlp", "sizes": [32, 160, 320], "prefix_length": 5},
                             serving_new_tokens=6, serving_tag_ids=[5, 6, 7]),
}
DECODES = {"deepseek-v2-lite": "deepseek_greedy_decode"}


def pytest_collection_modifyitems(items):
    from benchmark.tests import tiny

    for name, sizes in TINY_CONFIGS.items():
        tiny.TINY_CONFIGS.setdefault(name, sizes)
    for item in items:
        decodes = getattr(getattr(item, "module", None), "DECODES", None)
        if isinstance(decodes, dict):
            for name, fn in DECODES.items():
                decodes.setdefault(name, fn)
