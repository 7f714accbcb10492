"""Device busy time a decode step spends in the unmerged LoRA deltas
(``layer.lora``: ``(x @ a) @ b * scale`` at each site) in the blocks
(outside ``decode.logits``), per traced step."""

from benchmark.spans import per_step_ms


def read(run):
    return per_step_ms(run, "lora")
