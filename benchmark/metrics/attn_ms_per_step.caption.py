"""Device busy time a decode step spends in its attention over the cache
(``layer.attn``: GPT-2's K1 call with its k/v commit; Mistral's RoPE,
k/v quantize and commit and attention, up to ``wo``), per traced step."""

from benchmark.spans import per_step_ms


def read(run):
    return per_step_ms(run, "attn")
