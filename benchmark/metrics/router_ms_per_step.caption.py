"""Device busy time a decode step spends routing its MoE layers' rows and
combining them back (``layer.router``: the gate GEMM, softmax, top k,
counts, offsets, the permuting gather; ``layer.combine``: the inverse
permutation, the weighted sum, the shared experts' add), per traced step."""

from benchmark.step_spans import per_step_ms


def read(run):
    return per_step_ms(run, "layer.router", "layer.combine")
