"""Device busy time a decode step spends in its MoE layers' routed experts
(``layer.experts``: the two grouped GEMMs and the SwiGLU between them),
per traced step."""

from benchmark.step_spans import per_step_ms


def read(run):
    return per_step_ms(run, "layer.experts")
