"""Device busy time a decode step spends under ``decode.logits`` (the final
norm, the vocabulary-wide LM head with its quantize and rescale, and its
LoRA where there is one), per traced step."""

from benchmark.spans import per_step_ms


def read(run):
    return per_step_ms(run, "logits")
