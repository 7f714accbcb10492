"""Device busy time a decode step spends in its norms (``layer.norm``) and
activations (``layer.act``: GELU, SwiGLU's product) in the blocks
(outside ``decode.logits``), per traced step."""

from benchmark.spans import per_step_ms


def read(run):
    return per_step_ms(run, "norm_act")
